"""The port's LoRA adapters (`weights/lora.py`) against the JAX package's.

Both packages convert the same numpy state dicts (the three published
namings) and merge into the same flux-tiny / tiny CogVideoX weights (the
JAX init, carried across by `weights/from_jax.py`). Tolerances are those of
`tests/test_lora.py`: 1e-5 absolute on merged f32 weights (1e-7 where an
entry must stay untouched), the expected delta A^T B^T alpha / r computed in
numpy. Quantized merges are held to one quantization step of the JAX
package's merge (the two round the same f32 sums, taken in another order),
and to the JAX test's bound against the f32 merge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conceptattention_torch import ConceptAttentionFluxPipeline as TorchPipeline
from conceptattention_torch import VideoConceptAttentionPipeline as TorchVideoPipeline
from conceptattention_torch.config import configs as t_configs
from conceptattention_torch.models.flux.dit import flux_forward as t_forward
from conceptattention_torch.models.video.dit import CogVideoXConfig as TVideoCfg
from conceptattention_torch.ops import quant as t_quant
from conceptattention_torch.ops.packing import make_img_ids as t_img_ids
from conceptattention_torch.weights import lora as t_lora
from conceptattention_torch.weights.from_jax import lora_from_numpy, params_from_numpy
from conceptattention_tpu import ConceptAttentionFluxPipeline as JaxPipeline
from conceptattention_tpu.config import configs as j_configs
from conceptattention_tpu.models.flux.dit import flux_forward as j_forward
from conceptattention_tpu.models.flux.params import init_flux_params
from conceptattention_tpu.models.video.dit import CogVideoXConfig as JVideoCfg
from conceptattention_tpu.models.video.dit import init_video_dit_params
from conceptattention_tpu.ops import quant as j_quant
from conceptattention_tpu.ops.packing import make_img_ids as j_img_ids
from conceptattention_tpu.pipeline.video_pipeline import (
    VideoConceptAttentionPipeline as JaxVideoPipeline,
)
from conceptattention_tpu.weights import lora as j_lora

torch.set_num_threads(2)  # six test workers share the host's cores

T_CFG, J_CFG = t_configs["flux-tiny"].params, j_configs["flux-tiny"].params
D, M = T_CFG.hidden_size, T_CFG.mlp_hidden_dim  # 128, 512; 4 heads
R = 4
ATOL = 1e-5
VIDEO = dict(num_attention_heads=2, attention_head_dim=16, in_channels=4, out_channels=4,
             time_embed_dim=8, text_embed_dim=16, num_layers=2, sample_width=8,
             sample_height=8, sample_frames=9, patch_size=2, max_text_seq_length=6)


def _f(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _delta(a, b, alpha=None):
    """Expected [in, out] delta of A [r, in], B [out, r]."""
    r = a.shape[0]
    return (a.T @ b.T) * ((alpha if alpha is not None else r) / r)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t_np(x):
    return x.detach().float().cpu().numpy()


@pytest.fixture(scope="module")
def params():
    """flux-tiny f32 weights in both packages (JAX init, carried across)."""
    j = init_flux_params(jax.random.PRNGKey(0), J_CFG, jnp.float32)
    return params_from_numpy(np_tree(j)), j


def convert_both(sd, **kw):
    """(port adapter, JAX adapter) of one state dict, their factors equal."""
    got = t_lora.convert_lora_state_dict(sd, T_CFG, **kw)
    want = j_lora.convert_lora_state_dict(sd, J_CFG, **kw)
    assert set(got) == set(want)
    for stack in want:
        assert set(got[stack]) == set(want[stack]), stack
        for leaf, factor in want[stack].items():
            for part in ("a", "b"):
                assert got[stack][leaf][part].dtype == torch.float32
                np.testing.assert_allclose(t_np(got[stack][leaf][part]),
                                           np.asarray(factor[part]), rtol=0, atol=1e-7,
                                           err_msg=f"{stack}.{leaf}.{part}")
    return got, want


def merged_pair(params, sd, strength=1.0):
    t_params, j_params = params
    got, want = convert_both(sd)
    return (t_lora.merge_lora(t_params, got, strength),
            j_lora.merge_lora(j_params, want, strength))


def check_leaf(t_merged, j_merged, t_base, stack, leaf, i, delta):
    """Layer i of a merged leaf: port == JAX, and merged - base == delta."""
    got = t_np(t_merged[stack][leaf]["w"][i])
    np.testing.assert_allclose(got, np.asarray(j_merged[stack][leaf]["w"][i]), rtol=0,
                               atol=ATOL, err_msg=f"{stack}.{leaf}[{i}] vs JAX")
    diff = (got - t_np(t_base[stack][leaf]["w"][i])).reshape(delta.shape)
    np.testing.assert_allclose(diff, delta, rtol=0, atol=ATOL, err_msg=f"{stack}.{leaf}[{i}]")


def test_bfl_naming_all_targets(params):
    specs = [
        ("double_blocks.{i}.img_attn.qkv", "double", "img_qkv", D, 3 * D),
        ("double_blocks.{i}.img_attn.proj", "double", "img_proj", D, D),
        ("double_blocks.{i}.img_mlp.0", "double", "img_mlp_in", D, M),
        ("double_blocks.{i}.txt_mlp.2", "double", "txt_mlp_out", M, D),
        ("double_blocks.{i}.txt_mod.lin", "double", "txt_mod", D, 6 * D),
        ("single_blocks.{i}.modulation.lin", "single", "mod", D, 3 * D),
    ]
    sd, expected, k = {}, {}, 0
    for i in range(T_CFG.depth):
        for tmpl, stack, leaf, d_in, d_out in specs:
            a, b = _f(k, R, d_in), _f(k + 1, d_out, R)
            k += 2
            base = tmpl.format(i=i)
            sd |= {f"{base}.lora_A.weight": a, f"{base}.lora_B.weight": b,
                   f"{base}.alpha": np.float32(8.0)}
            expected[(stack, leaf, i)] = _delta(a, b, 8.0)
    t_merged, j_merged = merged_pair(params, sd)
    for (stack, leaf, i), delta in expected.items():
        check_leaf(t_merged, j_merged, params[0], stack, leaf, i, delta)
    # untouched leaves are the same tensors
    assert t_merged["double"]["img_qnorm"] is params[0]["double"]["img_qnorm"]
    assert t_merged["single"]["qkv"] is params[0]["single"]["qkv"]
    assert t_merged["double"]["img_proj"]["w"] is not params[0]["double"]["img_proj"]["w"]


def test_single_block_fused_linear_splits(params):
    """linear1 splits on the output axis (qkv | mlp_in), linear2 on the
    input axis (proj | mlp_out), as the checkpoint converter splits them."""
    a1, b1 = _f(0, R, D), _f(1, 3 * D + M, R)
    a2, b2 = _f(2, R, D + M), _f(3, D, R)
    sd = {}
    for i in range(T_CFG.depth_single_blocks):
        sd |= {f"single_blocks.{i}.linear1.lora_A.weight": a1,
               f"single_blocks.{i}.linear1.lora_B.weight": b1,
               f"single_blocks.{i}.linear2.lora_A.weight": a2,
               f"single_blocks.{i}.linear2.lora_B.weight": b2}
    t_merged, j_merged = merged_pair(params, sd)
    d1, d2 = _delta(a1, b1), _delta(a2, b2)
    for i in range(T_CFG.depth_single_blocks):
        check_leaf(t_merged, j_merged, params[0], "single", "qkv", i, d1[:, : 3 * D])
        check_leaf(t_merged, j_merged, params[0], "single", "mlp_in", i, d1[:, 3 * D:])
        check_leaf(t_merged, j_merged, params[0], "single", "proj", i, d2[:D])
        check_leaf(t_merged, j_merged, params[0], "single", "mlp_out", i, d2[D:])


@pytest.mark.parametrize("naming", ["kohya", "kohya_transformer", "transformer_prefix"])
def test_other_namings_match_bfl(naming):
    a, b = _f(0, R, D), _f(1, D, R)
    bfl = {"double_blocks.1.img_attn.proj.lora_A.weight": a,
           "double_blocks.1.img_attn.proj.lora_B.weight": b,
           "double_blocks.1.img_attn.proj.alpha": np.float32(2.0)}
    if naming.startswith("kohya"):
        prefix = "lora_unet" if naming == "kohya" else "lora_transformer"
        other = {f"{prefix}_double_blocks_1_img_attn_proj.lora_down.weight": a,
                 f"{prefix}_double_blocks_1_img_attn_proj.lora_up.weight": b,
                 f"{prefix}_double_blocks_1_img_attn_proj.alpha": np.float32(2.0)}
    else:
        other = {f"transformer.{k}": v for k, v in bfl.items()}
    ref, _ = convert_both(bfl)
    got, _ = convert_both(other)
    for part in ("a", "b"):
        assert torch.equal(got["double"]["img_proj"][part], ref["double"]["img_proj"][part])


def test_diffusers_qkv_thirds_and_proj_out_split(params):
    """Separate to_q / to_v land in the fused qkv as a block-diagonal factor
    (4 heads: a reshape that mixed heads would show); single-block proj_out
    splits its rows as linear2; text-encoder modules are skipped."""
    aq, bq = _f(0, R, D), _f(1, D, R)
    av, bv = _f(2, R, D), _f(3, D, R)
    ap, bp = _f(4, R, D + M), _f(5, D, R)
    sd = {
        "transformer.transformer_blocks.0.attn.to_q.lora_A.weight": aq,
        "transformer.transformer_blocks.0.attn.to_q.lora_B.weight": bq,
        "transformer.transformer_blocks.0.attn.to_v.lora_A.weight": av,
        "transformer.transformer_blocks.0.attn.to_v.lora_B.weight": bv,
        "single_transformer_blocks.1.proj_out.lora_A.weight": ap,
        "single_transformer_blocks.1.proj_out.lora_B.weight": bp,
        "text_encoder.layers.0.fc1.lora_A.weight": _f(6, R, 8),
        "text_encoder.layers.0.fc1.lora_B.weight": _f(7, 8, R),
    }
    t_merged, j_merged = merged_pair(params, sd)
    full = np.zeros((D, 3 * D), np.float32)
    full[:, :D], full[:, 2 * D:] = _delta(aq, bq), _delta(av, bv)
    check_leaf(t_merged, j_merged, params[0], "double", "img_qkv", 0, full)
    check_leaf(t_merged, j_merged, params[0], "double", "img_qkv", 1, np.zeros((D, 3 * D)))
    dp = _delta(ap, bp)
    check_leaf(t_merged, j_merged, params[0], "single", "proj", 1, dp[:D])
    check_leaf(t_merged, j_merged, params[0], "single", "mlp_out", 1, dp[D:])
    # the fused qkv's head layout: q of head h is columns [h*hd, (h+1)*hd)
    w = t_merged["double"]["img_qkv"]["w"][0]
    assert w.shape == (D, 3, T_CFG.num_heads, D // T_CFG.num_heads)
    got_q = t_np(w - params[0]["double"]["img_qkv"]["w"][0])[:, 0]
    np.testing.assert_allclose(got_q.reshape(D, D), _delta(aq, bq), atol=ATOL)


def test_mixed_ranks_pad_to_largest():
    """Layers with different ranks zero-pad to the largest, in both."""
    sd = {"double_blocks.0.img_attn.proj.lora_A.weight": _f(0, 2, D),
          "double_blocks.0.img_attn.proj.lora_B.weight": _f(1, D, 2),
          "double_blocks.1.img_attn.proj.lora_A.weight": _f(2, 6, D),
          "double_blocks.1.img_attn.proj.lora_B.weight": _f(3, D, 6)}
    got, _ = convert_both(sd)
    assert got["double"]["img_proj"]["a"].shape == (T_CFG.depth, D, 6)
    assert not got["double"]["img_proj"]["a"][0, :, 2:].any()


def test_strict_raises_on_unknown_module():
    sd = {"double_blocks.0.bogus.lora_A.weight": _f(0, R, D),
          "double_blocks.0.bogus.lora_B.weight": _f(1, D, R)}
    with pytest.raises(ValueError, match="unrecognized"):
        t_lora.convert_lora_state_dict(sd, T_CFG)
    with pytest.raises(ValueError):
        j_lora.convert_lora_state_dict(sd, J_CFG)
    assert t_lora.convert_lora_state_dict(sd, T_CFG, strict=False) == {"double": {}, "single": {}}


def test_load_lora_from_safetensors(tmp_path, params):
    """`load_lora` reads a `.safetensors` file through the port's own reader;
    the torch state dict and the numpy one convert alike."""
    from safetensors.torch import save_file

    sd = {"double_blocks.0.img_mlp.0.lora_A.weight": _f(0, R, D),
          "double_blocks.0.img_mlp.0.lora_B.weight": _f(1, M, R),
          "double_blocks.0.img_mlp.0.alpha": np.float32(2.0)}
    path = str(tmp_path / "adapter.safetensors")
    save_file({k: torch.from_numpy(np.asarray(v).copy()) for k, v in sd.items()}, path)
    got = t_lora.load_lora(path, T_CFG)
    want, _ = convert_both(sd)
    for part in ("a", "b"):
        assert torch.equal(got["double"]["img_mlp_in"][part], want["double"]["img_mlp_in"][part])


QUANT_SD = {"double_blocks.0.img_mlp.0.lora_A.weight": _f(0, R, D) * 0.05,
            "double_blocks.0.img_mlp.0.lora_B.weight": _f(1, M, R) * 0.05,
            "double_blocks.1.img_attn.qkv.lora_A.weight": _f(2, R, D) * 0.05,
            "double_blocks.1.img_attn.qkv.lora_B.weight": _f(3, 3 * D, R) * 0.05}


def _dequant(cell):
    """A quantized cell (either package's, as numpy) -> f32 numpy."""
    cell = {k: np.asarray(v) for k, v in cell.items()}
    if "q4p" in cell:
        return np.asarray(j_quant.dequantize_w4(jax.tree.map(jnp.asarray, cell), jnp.float32))
    q = cell["qa"] if "qa" in cell else cell["q"]
    return q.astype(np.float32) * cell["scale"].astype(np.float32)


@pytest.mark.parametrize("mode", ["w8", "w8a8", "w4"])
def test_quantized_merge_tracks_f32_merge(params, mode):
    """A merge into quantized cells requantizes in kind: the port's cells
    have the JAX merge's keys, shapes and dtypes, dequantize to within one
    step of it, and stay within the JAX test's bound of the f32 merge."""
    t_params, j_params = params
    group = 32
    j_q = j_quant.quantize_flux_params(j_params, min_size=0, mode=mode, group_size=group)
    t_q = t_quant.int8_gemm_layout(
        t_quant.quantize_flux_params(t_params, min_size=0, mode=mode, group_size=group))
    t_ad, j_ad = convert_both(QUANT_SD)
    t_m, j_m = t_lora.merge_lora(t_q, t_ad), j_lora.merge_lora(j_q, j_ad)
    ref = j_lora.merge_lora(j_params, j_ad)
    for leaf in ("img_mlp_in", "img_qkv"):
        got, want = t_m["double"][leaf]["w"], j_m["double"][leaf]["w"]
        assert set(got) == set(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, (leaf, k)
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), (leaf, k)
        scale = np.asarray(want["gscale" if mode == "w4" else "scale"], np.float32)
        step = scale.max()
        g, w = _dequant({k: t_np(v) if v.is_floating_point() else v.numpy() for k, v in got.items()}), _dequant(want)
        assert np.abs(g - w).max() <= step * (1 + 1e-6), (leaf, np.abs(g - w).max(), step)
        f32 = np.asarray(ref["double"][leaf]["w"], np.float32)
        bound = np.abs(f32).max() / (7.0 if mode == "w4" else 127.0)
        assert np.abs(g - f32).max() <= bound, leaf
    # the untouched quantized leaves are the same tensors
    assert t_m["double"]["txt_mlp_in"] is t_q["double"]["txt_mlp_in"]


@pytest.mark.parametrize("leaf", ["img_mlp_in", "img_qkv"])
def test_w8a8_layout_after_merge(params, leaf):
    """A merged w8a8 stack comes back input-axis-fastest: each layer,
    reshaped to [in, out], is a column-major view (what `int8_matmul`
    takes on a card without a copy)."""
    t_q = t_quant.int8_gemm_layout(
        t_quant.quantize_flux_params(params[0], min_size=0, mode="w8a8"))
    t_ad, _ = convert_both(QUANT_SD)
    qa = t_lora.merge_lora(t_q, t_ad)["double"][leaf]["w"]["qa"]
    for i in range(qa.shape[0]):
        w2 = qa[i].reshape(qa.shape[1], -1)
        assert w2.stride(0) == 1, (leaf, i, w2.stride())
    laid = t_quant.int8_gemm_layout({"w": {"qa": qa, "scale": None}})["w"]["qa"]
    assert laid.data_ptr() == qa.data_ptr() and laid.stride() == qa.stride()  # no copy


def test_bf16_merge_rounds_once(params):
    """bf16 weights merge in f32 and round once: the port's merge equals
    (w.f32 + delta).bf16 bit for bit, and the JAX merge to one bf16 step."""
    t_params, j_params = params
    t_bf = {"double": {"img_proj": {"w": t_params["double"]["img_proj"]["w"].bfloat16()}}}
    j_bf = {"double": {"img_proj": {"w": j_params["double"]["img_proj"]["w"].astype(jnp.bfloat16)}}}
    sd = {"double_blocks.0.img_attn.proj.lora_A.weight": _f(0, R, D) * 0.1,
          "double_blocks.0.img_attn.proj.lora_B.weight": _f(1, D, R) * 0.1}
    t_ad, j_ad = convert_both(sd)
    got = t_lora.merge_lora(t_bf, t_ad, 0.7)["double"]["img_proj"]["w"]
    want = j_lora.merge_lora(j_bf, j_ad, 0.7)["double"]["img_proj"]["w"]
    assert got.dtype == torch.bfloat16
    a, b = t_ad["double"]["img_proj"]["a"], t_ad["double"]["img_proj"]["b"]
    delta = torch.stack([a[i] @ b[i] for i in range(a.shape[0])])
    once = (t_bf["double"]["img_proj"]["w"].float() + delta * 0.7).bfloat16()
    assert torch.equal(got, once)
    w = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(t_np(got), w, rtol=2.0**-7, atol=0)


def test_forward_changes_and_strength_zero_identity(params):
    """flux_forward on merged weights, port against JAX; strength 0 leaves
    the base output, strength 1 moves it (the JAX test's 1e-6 and 1e-3)."""
    t_params, j_params = params
    sd = {"double_blocks.0.img_attn.qkv.lora_A.weight": _f(0, R, D),
          "double_blocks.0.img_attn.qkv.lora_B.weight": _f(1, 3 * D, R)}
    t_ad, j_ad = convert_both(sd)
    b, p, t = 1, 16, 4
    img, txt, y = _f(10, b, p, T_CFG.in_channels), _f(11, b, t, T_CFG.context_in_dim), \
        _f(12, b, T_CFG.vec_in_dim)
    t_args = dict(img=torch.from_numpy(img), img_ids=t_img_ids(4, 4, b),
                  txt=torch.from_numpy(txt), txt_ids=torch.zeros(b, t, 3),
                  timesteps=torch.full((b,), 0.5), y=torch.from_numpy(y))
    j_args = dict(img=jnp.asarray(img), img_ids=j_img_ids(4, 4, b), txt=jnp.asarray(txt),
                  txt_ids=jnp.zeros((b, t, 3)), timesteps=jnp.full((b,), 0.5), y=jnp.asarray(y))
    base, _ = t_forward(t_params, T_CFG, **t_args)
    out0, _ = t_forward(t_lora.merge_lora(t_params, t_ad, 0.0), T_CFG, **t_args)
    np.testing.assert_allclose(t_np(out0), t_np(base), atol=1e-6)
    out1, _ = t_forward(t_lora.merge_lora(t_params, t_ad, 1.0), T_CFG, **t_args)
    assert np.abs(t_np(out1) - t_np(base)).max() > 1e-3
    want, _ = j_forward(j_lora.merge_lora(j_params, j_ad, 1.0), J_CFG, **j_args)
    np.testing.assert_allclose(t_np(out1), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pipes():
    j = JaxPipeline("flux-tiny", dtype=jnp.float32)
    t = TorchPipeline("flux-tiny", dtype=torch.float32, device="cpu",
                      params=params_from_numpy(np_tree(j.params)),
                      ae_params=params_from_numpy(np_tree(j.ae_params)))
    return t, j


PROJ_SD = {"double_blocks.0.img_attn.proj.lora_A.weight": _f(0, R, D),
           "double_blocks.0.img_attn.proj.lora_B.weight": _f(1, D, R)}


def test_pipeline_lora_argument(pipes):
    """`lora=` (an adapter tree) at strength 0.5 in both pipelines: the
    adapted weights agree, layer 1 untouched (the JAX test's 2e-3 against
    the numpy delta, 1e-7 untouched)."""
    t, j = pipes
    t_ad, j_ad = convert_both(PROJ_SD)
    t_a = TorchPipeline("flux-tiny", dtype=torch.float32, device="cpu", params=t.params,
                        ae_params=t.ae_params, lora=t_ad, lora_strength=0.5)
    j_a = JaxPipeline("flux-tiny", dtype=jnp.float32, params=j.params, ae_params=j.ae_params,
                      lora=j_ad, lora_strength=0.5)
    d = t_np(t_a.params["double"]["img_proj"]["w"]) - t_np(t.params["double"]["img_proj"]["w"])
    expected = 0.5 * _delta(PROJ_SD["double_blocks.0.img_attn.proj.lora_A.weight"],
                            PROJ_SD["double_blocks.0.img_attn.proj.lora_B.weight"])
    np.testing.assert_allclose(d[0], expected, atol=2e-3)
    np.testing.assert_allclose(d[1], 0.0, atol=1e-7)
    np.testing.assert_allclose(t_np(t_a.params["double"]["img_proj"]["w"]),
                               np.asarray(j_a.params["double"]["img_proj"]["w"]), atol=ATOL)
    assert t_a.active_loras == j_a.active_loras == [{"source": "<adapter pytree>",
                                                     "strength": 0.5}]


def test_pipeline_lora_paths_and_strengths(pipes, tmp_path):
    """A list of `.safetensors` paths with one strength each, as the CLI and
    the daemon pass them: descriptors name the paths; the merge is the
    sequential one."""
    from safetensors.numpy import save_file

    t, j = pipes
    paths = []
    for n, seed in enumerate((0, 2)):
        sd = {"double_blocks.0.img_attn.proj.lora_A.weight": _f(seed, R, D),
              "double_blocks.0.img_attn.proj.lora_B.weight": _f(seed + 1, D, R)}
        paths.append(str(tmp_path / f"a{n}.safetensors"))
        save_file(sd, paths[-1])
    t_a = TorchPipeline("flux-tiny", dtype=torch.float32, device="cpu", params=t.params,
                        ae_params=t.ae_params, lora=paths, lora_strength=[0.3, 0.7])
    j_a = JaxPipeline("flux-tiny", dtype=jnp.float32, params=j.params, ae_params=j.ae_params,
                      lora=paths, lora_strength=[0.3, 0.7])
    assert t_a.active_loras == j_a.active_loras
    assert [d["source"] for d in t_a.active_loras] == paths
    np.testing.assert_allclose(t_np(t_a.params["double"]["img_proj"]["w"]),
                               np.asarray(j_a.params["double"]["img_proj"]["w"]), atol=ATOL)
    with pytest.raises(ValueError, match="strengths"):
        TorchPipeline("flux-tiny", dtype=torch.float32, device="cpu", params=t.params,
                      ae_params=t.ae_params, lora=paths, lora_strength=[1.0])


def test_swap_loras_matches_construction_and_clear_restores(pipes):
    """`swap_loras` builds what the constructor builds for the same adapter,
    and a clear gives the pre-merge tree back bit for bit; without
    `keep_base_for_swap` it refuses."""
    t, _ = pipes
    t_ad, _ = convert_both(PROJ_SD)
    swap = TorchPipeline("flux-tiny", dtype=torch.float32, device="cpu", params=t.params,
                         ae_params=t.ae_params, keep_base_for_swap=True)
    assert swap.active_loras == []
    got = swap.swap_loras(t_ad, 0.7)
    assert got == [{"source": "<adapter pytree>", "strength": 0.7}]
    direct = TorchPipeline("flux-tiny", dtype=torch.float32, device="cpu", params=t.params,
                           ae_params=t.ae_params, lora=t_ad, lora_strength=0.7)
    assert torch.equal(swap.params["double"]["img_proj"]["w"],
                       direct.params["double"]["img_proj"]["w"])
    assert swap.swap_loras(None) == []
    assert torch.equal(swap.params["double"]["img_proj"]["w"], t.params["double"]["img_proj"]["w"])
    with pytest.raises(RuntimeError, match="keep_base_for_swap"):
        t.swap_loras(t_ad)


def test_swap_loras_keeps_previous_set_on_failure(pipes):
    """A swap whose adapter names an unknown leaf raises and leaves the
    previous adapter set merged."""
    t, _ = pipes
    t_ad, _ = convert_both(PROJ_SD)
    swap = TorchPipeline("flux-tiny", dtype=torch.float32, device="cpu", params=t.params,
                         ae_params=t.ae_params, keep_base_for_swap=True, lora=t_ad)
    before = swap.params["double"]["img_proj"]["w"]
    bad = {"double": {"no_such_leaf": t_ad["double"]["img_proj"]}}
    with pytest.raises(KeyError, match="no_such_leaf"):
        swap.swap_loras(bad)
    assert torch.equal(swap.params["double"]["img_proj"]["w"], before)
    assert swap.active_loras == [{"source": "<adapter pytree>", "strength": 1.0}]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A bf16 flux-tiny DiT file in the official key names, and the VAE."""
    from safetensors.torch import save_file
    from test_torch_convert import ae_state_dict, flux_state_dict

    spec = t_configs["flux-tiny"]
    root = tmp_path_factory.mktemp("ckpt")
    flux = {k: v.to(torch.bfloat16) for k, v in flux_state_dict(spec.params, seed=1).items()}
    save_file(flux, str(root / "flux-tiny.safetensors"))
    save_file(ae_state_dict(spec.ae_params, seed=2), str(root / "ae-tiny.safetensors"))
    return str(root / "flux-tiny.safetensors"), str(root / "ae-tiny.safetensors")


@pytest.mark.parametrize("quantize", [False, "w8a8", "w4"])
def test_checkpoint_lora_merges_before_quantize(checkpoint, monkeypatch, quantize):
    """On the checkpoint path the adapter merges before the host quantize
    (JAX's order): the port's tree equals the JAX pipeline's, and a swap on
    the quantize path rebuilds from the bf16 base ("prequant")."""
    monkeypatch.setenv("FLUX_TINY", checkpoint[0])
    monkeypatch.setenv("AE_TINY", checkpoint[1])
    monkeypatch.setenv("AE", "/nonexistent")
    t_ad, j_ad = convert_both(QUANT_SD)
    t = TorchPipeline("flux-tiny", dtype=torch.float32, device="cpu", quantize=quantize,
                      lora=t_ad, keep_base_for_swap=True)
    j = JaxPipeline("flux-tiny", dtype=jnp.float32, quantize=quantize, lora=j_ad)
    assert t._swap_stage == ("prequant" if quantize else "final")
    got, want = t.params["double"]["img_mlp_in"]["w"], j.params["double"]["img_mlp_in"]["w"]
    if quantize:
        assert set(got) == set(want)
        np.testing.assert_allclose(
            _dequant({k: t_np(v) if v.is_floating_point() else v.numpy() for k, v in got.items()}),
            _dequant(want), rtol=0, atol=float(np.asarray(next(
                v for k, v in want.items() if "scale" in k)).max()) * (1 + 1e-6))
    else:
        np.testing.assert_allclose(t_np(got), np.asarray(want), atol=ATOL)
    before = {k: v.clone() for k, v in got.items()} if quantize else got.clone()
    t.swap_loras(None)
    t.swap_loras(t_ad)
    after = t.params["double"]["img_mlp_in"]["w"]
    if quantize:
        assert all(torch.equal(after[k], before[k]) for k in before)
    else:
        assert torch.equal(after, before)


def test_lora_from_numpy_carries_a_jax_adapter(params):
    """A JAX-converted adapter carried across merges as the port's own."""
    sd = {"double_blocks.1.txt_attn.qkv.lora_A.weight": _f(0, R, D),
          "double_blocks.1.txt_attn.qkv.lora_B.weight": _f(1, 3 * D, R)}
    t_ad, j_ad = convert_both(sd)
    carried = lora_from_numpy(np_tree(j_ad))
    assert carried["double"]["txt_qkv"]["a"].dtype == torch.float32
    a = t_lora.merge_lora(params[0], carried)["double"]["txt_qkv"]["w"]
    b = t_lora.merge_lora(params[0], t_ad)["double"]["txt_qkv"]["w"]
    np.testing.assert_allclose(t_np(a), t_np(b), atol=1e-7)


def test_merge_loras_stacks_additively(params):
    sd1 = {"double_blocks.0.img_attn.proj.lora_A.weight": _f(0, R, D),
           "double_blocks.0.img_attn.proj.lora_B.weight": _f(1, D, R)}
    sd2 = {"double_blocks.0.img_attn.proj.lora_A.weight": _f(2, R, D),
           "double_blocks.0.img_attn.proj.lora_B.weight": _f(3, D, R)}
    (t1, j1), (t2, j2) = convert_both(sd1), convert_both(sd2)
    both = t_lora.merge_loras(params[0], [t1, t2], [0.3, 0.7])
    manual = t_lora.merge_lora(t_lora.merge_lora(params[0], t1, 0.3), t2, 0.7)
    want = j_lora.merge_loras(params[1], [j1, j2], [0.3, 0.7])
    np.testing.assert_allclose(t_np(both["double"]["img_proj"]["w"]),
                               t_np(manual["double"]["img_proj"]["w"]), atol=1e-6)
    np.testing.assert_allclose(t_np(both["double"]["img_proj"]["w"]),
                               np.asarray(want["double"]["img_proj"]["w"]), atol=ATOL)


def test_merge_without_requantize_returns_dense_f32(params):
    """requantize=False (the training form) returns the dense f32 merge of
    a quantized leaf, as JAX does."""
    t_q = t_quant.quantize_flux_params(params[0], min_size=0, mode="w8")
    j_q = j_quant.quantize_flux_params(params[1], min_size=0, mode="w8")
    t_ad, j_ad = convert_both(QUANT_SD)
    got = t_lora.merge_lora(t_q, t_ad, requantize=False)["double"]["img_mlp_in"]["w"]
    want = j_lora.merge_lora(j_q, j_ad, requantize=False)["double"]["img_mlp_in"]["w"]
    assert got.dtype == torch.float32
    np.testing.assert_allclose(t_np(got), np.asarray(want), atol=ATOL)


# ---------------------------------------------------------------------------
# CogVideoX


@pytest.fixture(scope="module")
def video_params():
    j = init_video_dit_params(jax.random.PRNGKey(14), JVideoCfg(**VIDEO), jnp.float32)
    return params_from_numpy(np_tree(j)), j


def test_video_cogvideox_lora(video_params):
    """diffusers-named CogVideoX adapters: to_q / to_k into the fused
    [D, 3D] qkv's thirds, the dotted norm1.lin leaf through the path walker."""
    t_params, j_params = video_params
    d = VIDEO["num_attention_heads"] * VIDEO["attention_head_dim"]
    aq, bq, ak, bk = _f(0, R, d), _f(1, d, R), _f(2, R, d), _f(3, d, R)
    n_in = t_params["blocks"]["norm1"]["lin"]["w"].shape[1]
    n_out = t_params["blocks"]["norm1"]["lin"]["w"].shape[-1]
    an, bn = _f(4, R, n_in), _f(5, n_out, R)
    sd = {"transformer.transformer_blocks.1.attn1.to_q.lora_A.weight": aq,
          "transformer.transformer_blocks.1.attn1.to_q.lora_B.weight": bq,
          "transformer.transformer_blocks.1.attn1.to_k.lora_A.weight": ak,
          "transformer.transformer_blocks.1.attn1.to_k.lora_B.weight": bk,
          "transformer_blocks.0.norm1.linear.lora_A.weight": an,
          "transformer_blocks.0.norm1.linear.lora_B.weight": bn}
    t_ad = t_lora.convert_cogvideox_lora_state_dict(sd, TVideoCfg(**VIDEO))
    j_ad = j_lora.convert_cogvideox_lora_state_dict(sd, JVideoCfg(**VIDEO))
    got, want = t_lora.merge_lora(t_params, t_ad), j_lora.merge_lora(j_params, j_ad)
    qkv = t_np(got["blocks"]["qkv"]["w"][1]) - t_np(t_params["blocks"]["qkv"]["w"][1])
    np.testing.assert_allclose(qkv[:, :d], _delta(aq, bq), atol=ATOL)
    np.testing.assert_allclose(qkv[:, d:2 * d], _delta(ak, bk), atol=ATOL)
    np.testing.assert_allclose(qkv[:, 2 * d:], 0.0, atol=1e-7)
    assert torch.equal(got["blocks"]["qkv"]["w"][0], t_params["blocks"]["qkv"]["w"][0])
    norm = t_np(got["blocks"]["norm1"]["lin"]["w"][0]) - t_np(t_params["blocks"]["norm1"]["lin"]["w"][0])
    np.testing.assert_allclose(norm, _delta(an, bn), atol=ATOL)
    for path in (("qkv",), ("norm1", "lin")):
        g, w = got["blocks"], want["blocks"]
        for p in path:
            g, w = g[p], w[p]
        np.testing.assert_allclose(t_np(g["w"]), np.asarray(w["w"]), atol=ATOL)
    assert got["blocks"]["proj"] is t_params["blocks"]["proj"]
    assert got["blocks"]["norm1"]["ln"] is t_params["blocks"]["norm1"]["ln"]
    with pytest.raises(ValueError, match="CogVideoX"):
        t_lora.convert_cogvideox_lora_state_dict(
            {"transformer_blocks.0.attn2.to_q.lora_A.weight": aq,
             "transformer_blocks.0.attn2.to_q.lora_B.weight": bq}, TVideoCfg(**VIDEO))


@pytest.mark.parametrize("strength", [0.5, [0.5]], ids=["scalar", "list"])
def test_video_pipeline_lora_argument(tmp_path, strength):
    """`lora=` on the video pipeline, a `.safetensors` path in diffusers
    naming, at one strength or a list of one: the merged DiT of both
    packages, the delta against the numpy one (the JAX test's 1e-5)."""
    from safetensors.numpy import save_file

    d = 32
    sd = {"transformer_blocks.0.attn1.to_out.0.lora_A.weight": _f(0, R, d),
          "transformer_blocks.0.attn1.to_out.0.lora_B.weight": _f(1, d, R)}
    path = str(tmp_path / "video.safetensors")
    save_file(sd, path)
    j_plain = JaxVideoPipeline(JVideoCfg(**VIDEO), dtype=jnp.float32, init_seed=3)
    base = params_from_numpy(np_tree(j_plain.params))
    t = TorchVideoPipeline(TVideoCfg(**VIDEO), dtype=torch.float32, device="cpu", params=base,
                           lora=[path] if isinstance(strength, list) else path,
                           lora_strength=strength)
    j = JaxVideoPipeline(JVideoCfg(**VIDEO), dtype=jnp.float32, init_seed=3, lora=path,
                         lora_strength=0.5)
    got, want = t.params["blocks"]["proj"]["w"], j.params["blocks"]["proj"]["w"]
    diff = t_np(got[0]) - t_np(base["blocks"]["proj"]["w"][0])
    np.testing.assert_allclose(diff, 0.5 * _delta(*sd.values()), atol=ATOL)
    np.testing.assert_allclose(t_np(got), np.asarray(want), atol=ATOL)
    assert torch.equal(got[1], base["blocks"]["proj"]["w"][1])
