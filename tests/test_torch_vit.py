"""The port's ViT and open_clip towers against the JAX package's.

Both packages hold the same weights: the JAX init, carried across by
`weights/from_jax.py`, at the JAX model zoo's tiny shapes (ViT 32^2, patch
8, 32 wide, 2 layers; open_clip 28^2, patch 14, 32 wide, text 16 tokens).
Everything runs in f32 on the CPU.

Tolerances: `ATOL` 1e-5 on the ViT logits and the open_clip outputs (values
of order 1; the two packages differ by about 1e-6, reduction order apart):
an exact-erf GELU in place of the tanh form moves these ViT logits by
3e-4, a 1e-5 LayerNorm eps in the blocks by 7e-3. The attention
probabilities to 1e-6. The converters bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_convert import _flat, assert_trees_equal

from conceptattention_torch.evals import model_zoo as t_zoo
from conceptattention_torch.models import clip_vit as t_clip
from conceptattention_torch.models import vit as t_vit
from conceptattention_torch.weights import convert as t_convert
from conceptattention_torch.weights.from_jax import (
    open_clip_params_from_numpy,
    vit_params_from_numpy,
)
from conceptattention_tpu.evals import model_zoo as j_zoo
from conceptattention_tpu.models import clip_vit as j_clip
from conceptattention_tpu.models import vit as j_vit
from conceptattention_tpu.weights import convert as j_convert

torch.set_num_threads(2)  # six test workers share the host's cores

ATOL = 1e-5
T_VIT, J_VIT = t_zoo.tiny_configs("DINO")["vit_cfg"], j_zoo.tiny_configs("DINO")["vit_cfg"]
T_CLIP, J_CLIP = t_zoo.tiny_configs("TextSpan"), j_zoo.tiny_configs("TextSpan")


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def vit():
    j = j_vit.init_vit_params(jax.random.PRNGKey(0), J_VIT)
    return j, vit_params_from_numpy(to_numpy(j))


@pytest.fixture(scope="module")
def open_clip():
    j = j_clip.init_open_clip_params(jax.random.PRNGKey(0), J_CLIP["vit_cfg"],
                                     J_CLIP["clip_txt_cfg"])
    return j, open_clip_params_from_numpy(to_numpy(j))


def images(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_vit_forward_matches_jax(vit):
    j, t = vit
    x = images((2, 3, 32, 32))
    want_logits, want_attn = j_vit.vit_forward(j, J_VIT, jnp.asarray(x), return_attn=True)
    got_logits, got_attn = t_vit.vit_forward(t, T_VIT, torch.from_numpy(x), return_attn=True)
    n = T_VIT.num_patches + 1
    assert got_attn.shape == (T_VIT.depth, 2, T_VIT.num_heads, n, n)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(want_attn), rtol=0, atol=1e-6)
    logits, attn = t_vit.vit_forward(t, T_VIT, torch.from_numpy(x))
    assert attn is None and torch.equal(logits, got_logits)


def test_vit_attn_deltas_shift_the_probabilities(vit):
    """A delta added to one layer's probabilities moves the logits as the
    JAX forward's does."""
    j, t = vit
    x = images((1, 3, 32, 32), seed=1)
    n = T_VIT.num_patches + 1
    delta = np.zeros((T_VIT.depth, 1, T_VIT.num_heads, n, n), np.float32)
    delta[1, 0, 0, 0, 1:] = 0.05
    want, _ = j_vit.vit_forward(j, J_VIT, jnp.asarray(x), attn_deltas=jnp.asarray(delta))
    got, _ = t_vit.vit_forward(t, T_VIT, torch.from_numpy(x),
                               attn_deltas=torch.from_numpy(delta))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_init_vit_params_shapes_and_scales():
    t = t_vit.init_vit_params(torch.Generator().manual_seed(0), T_VIT)
    j = j_vit.init_vit_params(jax.random.PRNGKey(0), J_VIT)
    got, want = _flat(t), _flat(j)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert t["blocks"]["attn"]["qkv"]["w"].std().item() == pytest.approx(
        T_VIT.hidden_size**-0.5, rel=0.1)
    assert torch.equal(t["blocks"]["norm1"]["scale"], torch.ones(T_VIT.depth, T_VIT.hidden_size))


def vit_state_dict(cfg, seed=0):
    """The timm / Chefer / DINO ViT keys at `cfg`'s shapes, random values."""
    g = torch.Generator().manual_seed(seed)
    d, m = cfg.hidden_size, int(cfg.hidden_size * cfg.mlp_ratio)

    def r(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    sd = {"patch_embed.proj.weight": r(d, cfg.in_channels, cfg.patch_size, cfg.patch_size),
          "patch_embed.proj.bias": r(d), "cls_token": r(1, 1, d),
          "pos_embed": r(1, cfg.num_patches + 1, d), "norm.weight": r(d), "norm.bias": r(d),
          "head.weight": r(cfg.num_classes, d), "head.bias": r(cfg.num_classes)}
    for i in range(cfg.depth):
        for name, (dout, din) in {"attn.qkv": (3 * d, d), "attn.proj": (d, d),
                                  "mlp.fc1": (m, d), "mlp.fc2": (d, m)}.items():
            sd[f"blocks.{i}.{name}.weight"], sd[f"blocks.{i}.{name}.bias"] = r(dout, din), r(dout)
        for name in ("norm1", "norm2"):
            sd[f"blocks.{i}.{name}.weight"], sd[f"blocks.{i}.{name}.bias"] = r(d), r(d)
    return sd


def open_clip_state_dict(vis, txt, seed=0):
    """open_clip's visual and text keys at the configs' shapes."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    def blocks(prefix, width, depth, mlp_ratio):
        m = int(width * mlp_ratio)
        out = {}
        for i in range(depth):
            base = f"{prefix}.{i}"
            out.update({f"{base}.attn.in_proj_weight": r(3 * width, width),
                        f"{base}.attn.in_proj_bias": r(3 * width)})
            for name, (dout, din) in {"attn.out_proj": (width, width), "mlp.c_fc": (m, width),
                                      "mlp.c_proj": (width, m)}.items():
                out[f"{base}.{name}.weight"], out[f"{base}.{name}.bias"] = r(dout, din), r(dout)
            for name in ("ln_1", "ln_2"):
                out[f"{base}.{name}.weight"], out[f"{base}.{name}.bias"] = r(width), r(width)
        return out

    w = vis.width
    sd = {"visual.conv1.weight": r(w, vis.in_channels, vis.patch_size, vis.patch_size),
          "visual.class_embedding": r(w), "visual.positional_embedding": r(vis.num_tokens, w),
          "visual.proj": r(w, vis.embed_dim),
          **blocks("visual.transformer.resblocks", w, vis.depth, vis.mlp_ratio),
          "token_embedding.weight": r(txt.vocab_size, txt.width),
          "positional_embedding": r(txt.context_length, txt.width),
          "text_projection": r(txt.width, txt.embed_dim),
          **blocks("transformer.resblocks", txt.width, txt.depth, txt.mlp_ratio)}
    for name, width in (("visual.ln_pre", w), ("visual.ln_post", w), ("ln_final", txt.width)):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = r(width), r(width)
    return sd


def test_convert_vit_state_dict_matches_jax():
    sd = vit_state_dict(T_VIT)
    got = t_convert.convert_vit_state_dict(sd, T_VIT)
    assert_trees_equal(got, j_convert.convert_vit_state_dict(
        {k: v.numpy() for k, v in sd.items()}, J_VIT, jnp.float32))


@pytest.mark.parametrize("tower", ["visual", "text"])
def test_convert_open_clip_matches_jax(tower):
    sd = open_clip_state_dict(T_CLIP["vit_cfg"], T_CLIP["clip_txt_cfg"])
    if tower == "visual":
        got = t_clip.convert_open_clip_visual(sd, T_CLIP["vit_cfg"])
        want = j_clip.convert_open_clip_visual(sd, J_CLIP["vit_cfg"])
    else:
        got = t_clip.convert_open_clip_text(sd, T_CLIP["clip_txt_cfg"])
        want = j_clip.convert_open_clip_text(sd, J_CLIP["clip_txt_cfg"])
    assert_trees_equal(got, want)


def test_converted_vit_runs_as_jax(tmp_path):
    """A checkpoint read by the port's loader and converter gives the JAX
    package's logits from its own loader and converter."""
    from safetensors.torch import save_file

    sd = vit_state_dict(T_VIT, seed=3)
    save_file(sd, str(tmp_path / "vit.safetensors"))
    t = t_convert.convert_vit_state_dict(t_convert.load_safetensors(str(tmp_path / "vit.safetensors")),
                                         T_VIT)
    j = j_convert.convert_vit_state_dict(j_convert.load_safetensors(str(tmp_path / "vit.safetensors")),
                                         J_VIT)
    x = images((1, 3, 32, 32), seed=2)
    want, _ = j_vit.vit_forward(j, J_VIT, jnp.asarray(x))
    got, _ = t_vit.vit_forward(t, T_VIT, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_open_clip_encode_image_and_prs_match_jax(open_clip):
    j, t = open_clip
    cfg_t, cfg_j = T_CLIP["vit_cfg"], J_CLIP["vit_cfg"]
    x = np.random.default_rng(0).random((2, 3, 28, 28)).astype(np.float32)
    rep = t_clip.encode_image(t["visual"], cfg_t, torch.from_numpy(x))
    np.testing.assert_allclose(rep.numpy(), np.asarray(j_clip.encode_image(
        j["visual"], cfg_j, jnp.asarray(x))), rtol=0, atol=ATOL)
    want_rep, want_col = j_clip.prs_decomposition(j["visual"], cfg_j, jnp.asarray(x))
    got_rep, got_col = t_clip.prs_decomposition(t["visual"], cfg_t, torch.from_numpy(x))
    assert got_col.shape == (2, cfg_t.num_tokens, cfg_t.embed_dim)
    np.testing.assert_allclose(got_rep.numpy(), np.asarray(want_rep), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_col.numpy(), np.asarray(want_col), rtol=0, atol=1e-6)
    # the decomposition's representation is the plain forward's
    np.testing.assert_allclose(got_rep.numpy(), rep.numpy(), rtol=0, atol=1e-6)


def test_open_clip_text_encode_matches_jax(open_clip):
    from conceptattention_torch.evals.textspan import _hash_tokenize

    j, t = open_clip
    ids = _hash_tokenize(T_CLIP["clip_txt_cfg"])(["a photo of a cat.", "the dog", "sky"])
    want = j_clip.text_encode(j["text"], J_CLIP["clip_txt_cfg"], jnp.asarray(ids))
    got = t_clip.text_encode(t["text"], T_CLIP["clip_txt_cfg"], torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_full_width_configs_match_jax():
    """ViT-B/16 and ViT-H/14 (vision and text) as the JAX package states them."""
    import dataclasses

    for got, want in ((t_vit.ViTConfig(), j_vit.ViTConfig()),
                      (t_clip.VIT_H_14, j_clip.VIT_H_14),
                      (t_clip.VIT_H_14_TEXT, j_clip.VIT_H_14_TEXT)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_vit_runs_in_f64(vit):
    """An f64 tree stays f64 through the forward (its LayerNorms and
    attention scores too), and agrees with the f32 JAX forward; the layer
    norm itself matches numpy in f64 to 1e-12."""
    from conceptattention_torch.ops.norms import layer_norm

    j, t = vit
    x = images((1, 3, 32, 32), seed=5)
    t64 = vit_params_from_numpy(to_numpy(j), dtype=torch.float64)
    logits, attn = t_vit.vit_forward(t64, T_VIT, torch.from_numpy(x).double(), return_attn=True)
    assert logits.dtype == attn.dtype == torch.float64
    want, _ = j_vit.vit_forward(j, J_VIT, jnp.asarray(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    a = np.random.default_rng(0).standard_normal((3, 40)) * 1e3 + 7.0
    ref = (a - a.mean(-1, keepdims=True)) / np.sqrt(a.var(-1, keepdims=True) + 1e-6)
    np.testing.assert_allclose(layer_norm(torch.from_numpy(a)).numpy(), ref, rtol=0, atol=1e-12)
