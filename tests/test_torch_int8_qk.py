"""The port's int8-score attention (`int8_qk=True`, K1b) and the batched
`generate_images`, against the JAX package's, on the CPU.

On a CPU tensor K1b's wrapper runs its plain PyTorch version, which takes the
JAX kernel's rounding points: roped q pre-scaled and quantized from f32,
roped k rounded to its dtype and quantized, per-row symmetric int8 with
round half to even, int32 sums, f32 row scales. Here it is held against the
JAX Pallas kernel in interpret mode on the same numpy inputs, in f32, at
1e-5 (f32 softmax sums in another order). Against the exact path it is held
to the JAX package's own bounds for int8 scores (`tests/test_kernels.py`):
max |d| < 0.05, mean |d| < 0.005, padded rows exactly zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conceptattention_torch import ConceptAttentionFluxPipeline as TorchPipeline
from conceptattention_torch.config import configs as t_configs
from conceptattention_torch.kernels import flash_saliency as t_fs
from conceptattention_torch.models.flux import blocks as t_blocks
from conceptattention_torch.models.flux import params as t_params
from conceptattention_torch.ops import attention as t_attn
from conceptattention_torch.ops import rope as t_rope
from conceptattention_tpu.kernels import flash_saliency as j_fs
from conceptattention_tpu.ops import packing as j_pack
from conceptattention_tpu.ops import rope as j_rope

torch.set_num_threads(2)  # six test workers share the host's cores

ATTN = dict(rtol=1e-5, atol=1e-5)
H, D = 2, 32
T, P, C = 8, 48, 3  # txt, img, concepts
AXES = (8, 12, 12)
BLOCK = 16  # JAX kernel tiles (interpret mode)
ABLATIONS = [(True, True), (True, False), (False, True), (False, False)]
PROMPTS, CONCEPTS = ["a dragon on a rock", "a cat on a mat"], ["dragon", "rock", "sky"]
SIZE, STEPS = 32, 2


def rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or ATTN))


def to_t(xs):
    return tuple(torch.from_numpy(x) for x in xs)


def to_j(xs):
    return tuple(jnp.asarray(x) for x in xs)


def both_pe(ids):
    return (t_rope.embed_nd(torch.from_numpy(ids), AXES, 10_000),
            j_rope.embed_nd(jnp.asarray(ids), AXES, 10_000))


@pytest.fixture(scope="module")
def data():
    """q/k/v over [txt | img | concept | pad] (q at 3x unit scale, so the
    int8 scores are peaked) and both packages' expanded RoPE tables."""
    img_ids = np.asarray(j_pack.make_img_ids(6, 8, 1))
    t_pe, j_pe = both_pe(np.concatenate([np.zeros((1, T, 3), np.float32), img_ids], 1))
    t_cpe, j_cpe = both_pe(np.concatenate([np.zeros((1, C, 3), np.float32), img_ids], 1))
    s = 64
    q, k, v = rand(0, 1, H, s, D, scale=3.0), rand(1, 1, H, s, D), rand(2, 1, H, s, D)
    t_tab = t_fs.expand_rope_tables([t_pe, (t_cpe[0][:, :, :C], t_cpe[1][:, :, :C])], s)
    j_tab = j_fs.expand_rope_tables([j_pe, (j_cpe[0][:, :, :C], j_cpe[1][:, :, :C])], s)
    segs = {name: tuple(rand(10 * i + j, 1, H, n, D) for j in range(3))
            for i, (name, n) in enumerate([("txt", T), ("img", P), ("con", C)], start=1)}
    return (q, k, v), t_tab, j_tab, segs, (t_pe, t_cpe), (j_pe, j_cpe)


@pytest.mark.parametrize("rope", [True, False])
@pytest.mark.parametrize("cross,self_attention", ABLATIONS)
def test_plain_int8_matches_pallas_int8(data, cross, self_attention, rope):
    """Every cross/self combination, with RoPE in the kernel (q pre-scaled
    before it is quantized) and without tables (the scale after the int32
    sums); pad rows and rows that see nothing come out as exact zeros."""
    qkv, t_tab, j_tab, *_ = data
    t_tab, j_tab = (t_tab, j_tab) if rope else ((None, None), (None, None))
    got = t_fs.fused_concept_flash_attention(
        *to_t(qkv), T, P, C, cross, self_attention, *t_tab, int8_qk=True)
    want = j_fs.fused_concept_flash_attention(
        *to_j(qkv), txt_len=T, img_len=P, concept_len=C, cross=cross,
        self_attention=self_attention, block_q=BLOCK, block_k=BLOCK, interpret=True,
        rope_cos=j_tab[0], rope_sin=j_tab[1], int8_qk=True)
    close(got, want)
    seen_by_nothing = T + P + (C if (cross or self_attention) else 0)
    np.testing.assert_array_equal(got[:, :, seen_by_nothing:].numpy(), 0.0)


@pytest.mark.parametrize("rope", [True, False])
def test_int8_close_to_exact(rope):
    """The JAX package's bounds for int8 scores against the exact kernel, on
    its own test's shape (256 rows: 32 txt, 192 img, 16 real concepts, 16
    pad rows)."""
    s, txt, img, con = 256, 32, 192, 16
    q, k, v = (torch.from_numpy(rand(40 + i, 1, H, s, D)) for i in range(3))
    tables = (torch.ones(1, s, D), torch.zeros(1, s, D)) if rope else (None, None)
    exact = t_fs.fused_concept_flash_attention(q, k, v, txt, img, con, True, True, *tables)
    got = t_fs.fused_concept_flash_attention(q, k, v, txt, img, con, True, True, *tables,
                                             int8_qk=True)
    diff = (got - exact).abs()
    assert diff.max().item() < 0.05 and diff.mean().item() < 0.005
    assert diff.max().item() > 0  # the flag reached the scores
    np.testing.assert_array_equal(got[:, :, txt + img + con:].numpy(), 0.0)


@pytest.mark.parametrize("rope", [True, False])
def test_plain_int8_zero_rows_matches_pallas_int8_d128(rope):
    """Head dim 128, the one that takes the Hopper instance on the card, with
    one all-zero q row (scale 0: it scores 0 against every visible key and
    weighs them alike) and one all-zero k row (it scores 0 for every query):
    the plain K1b against the JAX kernel in interpret mode, outputs finite,
    pad rows exact zeros."""
    d, s = 128, 64
    q, k, v = rand(90, 1, H, s, d, scale=3.0), rand(91, 1, H, s, d), rand(92, 1, H, s, d)
    q[:, :, T + 5] = 0.0  # an img query row
    k[:, :, T + 9] = 0.0  # an img key row
    t_tab, j_tab = (None, None), (None, None)
    if rope:
        axes = (16, 56, 56)
        img_ids = np.asarray(j_pack.make_img_ids(6, 8, 1))
        ids = [np.concatenate([np.zeros((1, n, 3), np.float32), img_ids], 1) for n in (T, C)]
        (t_pe, j_pe), (t_cpe, j_cpe) = ((t_rope.embed_nd(torch.from_numpy(x), axes, 10_000),
                                         j_rope.embed_nd(jnp.asarray(x), axes, 10_000))
                                        for x in ids)
        t_tab = t_fs.expand_rope_tables([t_pe, (t_cpe[0][:, :, :C], t_cpe[1][:, :, :C])], s)
        j_tab = j_fs.expand_rope_tables([j_pe, (j_cpe[0][:, :, :C], j_cpe[1][:, :, :C])], s)
    got = t_fs.fused_concept_flash_attention(
        *to_t((q, k, v)), T, P, C, True, True, *t_tab, int8_qk=True)
    want = j_fs.fused_concept_flash_attention(
        *to_j((q, k, v)), txt_len=T, img_len=P, concept_len=C, block_q=BLOCK, block_k=BLOCK,
        interpret=True, rope_cos=j_tab[0], rope_sin=j_tab[1], int8_qk=True)
    close(got, want)
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(got[:, :, T + P + C:].numpy(), 0.0)
    # the zero q row weighs its T + P visible keys alike: the mean of their v rows
    close(got[:, :, T + 5], torch.from_numpy(v[:, :, :T + P].mean(axis=2)))


@pytest.mark.parametrize("d,instance", [(32, "mma_sync"), (64, "mma_sync"), (128, "hopper")])
def test_int8_instance_routing(d, instance):
    """K1b's card instance per head dim: the Hopper kernel takes the flux
    blocks' 128, the mma.sync kernel keeps 32 (flux-tiny) and 64."""
    assert t_fs.int8_instance(d) == instance
    assert d in t_fs.INT8_HEAD_DIMS


def test_row_quantizer_rounding_points():
    """max|x| * f32(1/127) as the scale, round half to even, and a zero row
    with scale 0 (so it scores 0)."""
    x = torch.tensor([[[[127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 0.0, 64.0]],
                       [[0.0] * 8]]])
    q8, qs, k8, ks = t_fs.quantize_qk_rows_plain(x, x)
    assert q8.dtype == torch.int8 and qs.dtype == torch.float32
    assert q8[0, 0, 0].tolist() == [127, 2, -4, 0, 0, 2, 0, 64]
    assert qs[0, 0, 0].item() == np.float32(127) * np.float32(1 / np.float32(127))
    assert not q8[0, 1].any() and qs[0, 1, 0].item() == 0.0
    assert torch.equal(q8, k8) and torch.equal(qs, ks)


def _compare_joint(got, want):
    for g, w, name in zip(got[:3], want[:3], ("txt", "img", "concept")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **ATTN)
    assert set(got[3]) == set(want[3])
    for key in want[3]:
        np.testing.assert_allclose(got[3][key].numpy(), np.asarray(want[3][key]), err_msg=key,
                                   **ATTN)


@pytest.mark.parametrize("cross,self_attention", [(True, True), (False, True)])
def test_joint_concept_attention_int8(data, cross, self_attention):
    """The port's joint attention with `int8_qk` in its spec against
    `pallas_joint_concept_attention(int8_qk=True)`, outputs and extras."""
    *_, segs, t_pes, j_pes = data
    got = t_attn.joint_concept_attention(
        to_t(segs["txt"]), to_t(segs["img"]), to_t(segs["con"]), *t_pes,
        t_attn.ConceptAttentionSpec(cross_attention=cross, self_attention=self_attention,
                                    int8_qk=True))
    want = j_fs.pallas_joint_concept_attention(
        to_j(segs["txt"]), to_j(segs["img"]), to_j(segs["con"]), *j_pes, cross=cross,
        self_attention=self_attention, block_q=BLOCK, block_k=BLOCK, interpret=True,
        int8_qk=True)
    _compare_joint(got, want)


def test_int8_never_takes_the_paired_kernel(monkeypatch):
    """Head dim 64 with an even head count and `PAIR_HEADS` on: the int8
    path stays on K1b, as the JAX package's dispatch does."""
    def refuse(*args, **kwargs):
        raise AssertionError("int8_qk reached the paired kernel")

    monkeypatch.setattr(t_fs, "PAIR_HEADS", True)
    monkeypatch.setattr(t_fs, "fused_concept_flash_attention_paired", refuse)
    ids = np.concatenate([np.zeros((1, T, 3), np.float32), np.asarray(j_pack.make_img_ids(6, 8, 1))], 1)
    pe = t_rope.embed_nd(torch.from_numpy(ids), (16, 24, 24), 10_000)
    txt, img = (tuple(torch.from_numpy(rand(60 + 3 * i + j, 1, 2, n, 64)) for j in range(3))
                for i, n in enumerate((T, P)))
    out = t_attn.joint_concept_attention(txt, img, None, pe, None,
                                         t_attn.ConceptAttentionSpec(int8_qk=True))
    assert out[1].shape == (1, P, 128) and torch.isfinite(out[1]).all()


def test_cpu_tensors_launch_no_int8_kernel(data):
    qkv, t_tab, *_ = data
    before = (t_fs.fused_concept_flash_attention_int8.launches,
              t_fs.fused_concept_flash_attention.launches)
    t_fs.fused_concept_flash_attention(*to_t(qkv), T, P, C, True, True, *t_tab, int8_qk=True)
    assert (t_fs.fused_concept_flash_attention_int8.launches,
            t_fs.fused_concept_flash_attention.launches) == before


def test_cpu_tensors_launch_no_hopper_int8_kernel():
    """The Hopper K1b wrapper on CPU tensors runs the plain version and
    counts no launch."""
    q, k, v = (torch.from_numpy(rand(95 + i, 1, H, 64, 128)) for i in range(3))
    counters = (t_fs.fused_concept_flash_attention_int8_hopper,
                t_fs.fused_concept_flash_attention_int8)
    before = [f.launches for f in counters]
    got = t_fs.fused_concept_flash_attention_int8_hopper(q, k, v, T, P, C)
    want = t_fs.fused_concept_flash_attention_plain(q, k, v, T, P, C, int8_qk=True)
    assert torch.equal(got, want)
    assert [f.launches for f in counters] == before


def test_int8_qk_rejects_non_fused_backends():
    """`int8_qk` with the plain SDPA backend raises instead of running exact
    scores: in the spec's consumer, the single block and the pipeline's
    constructor (as the JAX package's `test_int8_qk_rejects_non_pallas_backends`)."""
    cfg = t_configs["flux-tiny"].params
    ids = np.concatenate([np.zeros((1, T, 3), np.float32), np.asarray(j_pack.make_img_ids(6, 8, 1))], 1)
    pe = t_rope.embed_nd(torch.from_numpy(ids), AXES, 10_000)
    txt, img = (to_t(tuple(rand(70 + 3 * i + j, 1, H, n, D) for j in range(3)))
                for i, n in enumerate((T, P)))
    with pytest.raises(ValueError, match="int8_qk"):
        t_attn.joint_concept_attention(
            txt, img, None, pe, None, t_attn.ConceptAttentionSpec(backend="sdpa", int8_qk=True))

    p = t_params.layer(t_params.init_flux_params(torch.Generator().manual_seed(0), cfg,
                                                 torch.float32)["single"], 0)
    x = torch.from_numpy(rand(80, 1, 64, cfg.hidden_size))
    vec = torch.from_numpy(rand(81, 1, cfg.hidden_size))
    spe = t_rope.embed_nd(torch.zeros(1, 64, 3), cfg.axes_dim, cfg.theta)
    with pytest.raises(ValueError, match="int8_qk"):
        t_blocks.single_block(p, x, vec, spe, cfg.num_heads, cfg.mlp_hidden_dim,
                              backend="sdpa", int8_qk=True)
    with pytest.raises(ValueError, match="int8_qk"):
        TorchPipeline("flux-tiny", dtype=torch.float32, device="cpu",
                      attention_backend="sdpa", int8_qk=True)
    with pytest.raises(ValueError, match="attention_backend"):
        TorchPipeline("flux-tiny", dtype=torch.float32, device="cpu", attention_backend="xla")
    with pytest.raises(KeyError, match="unknown stack"):  # an adapter naming no DiT stack
        TorchPipeline("flux-tiny", dtype=torch.float32, device="cpu", lora={"a": 1})


@pytest.fixture(scope="module")
def pipe():
    return TorchPipeline("flux-tiny", dtype=torch.float32, device="cpu")


def run_images(pipe, **kw):
    return pipe.generate_images(PROMPTS, CONCEPTS, width=SIZE, height=SIZE,
                                num_inference_steps=STEPS, return_pil_heatmaps=False,
                                return_image_array=True, **kw)


def test_generate_images_with_seeds_equals_generate_image(pipe):
    """With `seeds`, each prompt of the batched call draws the noise of
    `generate_image(seed=s)`: its heatmaps match that call's to 1e-4 (one
    batched denoise against two of one row, sums in another order), its
    image to one grey level."""
    seeds = [3, 11]
    outs = run_images(pipe, seeds=seeds)
    assert len(outs) == len(PROMPTS)
    for out, prompt, s in zip(outs, PROMPTS, seeds):
        one = pipe.generate_image(prompt, CONCEPTS, width=SIZE, height=SIZE,
                                  num_inference_steps=STEPS, seed=s, return_pil_heatmaps=False,
                                  return_image_array=True)
        close(out.concept_heatmaps, one.concept_heatmaps, rtol=1e-4, atol=1e-4)
        close(out.cross_attention_maps, one.cross_attention_maps, rtol=1e-4, atol=1e-4)
        assert out.image.dtype == np.uint8 and out.image.shape == (SIZE, SIZE, 3)
        assert np.abs(out.image.astype(int) - one.image.astype(int)).max() <= 1
    assert not np.array_equal(outs[0].image, outs[1].image)


def test_generate_images_without_seeds_and_edge_cases(pipe):
    """Without `seeds`: one [B, ...] draw, one output per prompt in order.
    An empty batch gives no output; a seed count that differs from the
    prompt count raises."""
    outs = run_images(pipe, seed=5)
    grid = SIZE // (2 * pipe.vae_factor)
    assert len(outs) == len(PROMPTS)
    for out in outs:
        assert out.concept_heatmaps.shape == (len(CONCEPTS), grid, grid)
        assert np.isfinite(out.concept_heatmaps).all() and out.image.shape == (SIZE, SIZE, 3)
    assert pipe.generate_images([], CONCEPTS) == []
    with pytest.raises(ValueError, match="seeds"):
        run_images(pipe, seeds=[1])


@pytest.mark.parametrize("quantize", ["w8", "w8a8", "w4"])
def test_quantized_pipeline_int8_qk(quantize):
    """The serving configuration on the CPU: random already-quantized
    weights, int8 scores, a batch of two; plain versions only, so no kernel
    launch is counted."""
    counters = (t_fs.fused_concept_flash_attention, t_fs.fused_concept_flash_attention_int8)
    before = [f.launches for f in counters]
    qpipe = TorchPipeline("flux-tiny", dtype=torch.float32, device="cpu", quantize=quantize,
                          int8_qk=True)
    cell = qpipe.params["double"]["img_mlp_in"]["w"]  # the layers of 2**16+ weights
    assert set(cell) == ({"q4p", "gscale"} if quantize == "w4" else
                         {"qa" if quantize == "w8a8" else "q", "scale"})
    outs = run_images(qpipe, seeds=[0, 1])
    for out in outs:
        assert np.isfinite(out.concept_heatmaps).all() and np.isfinite(out.cross_attention_maps).all()
        assert out.image.dtype == np.uint8
    assert [f.launches for f in counters] == before


def test_stacked_int8_paths_preserve_quality():
    """The JAX package's quality gate for w8a8 weights with int8 scores
    (`tests/test_quant.py::TestW8A8PlusInt8QKQuality`), on the port: the
    same flux-tiny weights, dense f32 against w8a8 + int8_qk, heatmaps
    within 5% of the largest value and a thresholded IoU of at least 0.9
    per concept."""
    from conceptattention_torch.ops.quant import quantize_flux_params

    cfg = t_configs["flux-tiny"].params
    params = t_params.init_flux_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    kwargs = dict(prompt="a dragon", concepts=["dragon", "rock"], width=64, height=64,
                  num_inference_steps=2, seed=3, return_pil_heatmaps=False,
                  return_image_array=True)
    ref = TorchPipeline("flux-tiny", dtype=torch.float32, device="cpu",
                        params=params).generate_image(**kwargs)
    combo = TorchPipeline("flux-tiny", dtype=torch.float32, device="cpu",
                          params=quantize_flux_params(params, min_size=0, act_quant=True),
                          int8_qk=True).generate_image(**kwargs)
    hf, hq = ref.concept_heatmaps, combo.concept_heatmaps
    assert np.abs(hf - hq).max() / (np.abs(hf).max() + 1e-9) < 0.05
    assert np.abs(hf - hq).max() > 0  # the quantized path ran
    for c in range(hf.shape[0]):
        mf, mq = hf[c] > hf[c].mean(), hq[c] > hq[c].mean()
        assert (mf & mq).sum() / max((mf | mq).sum(), 1) >= 0.9, c
