"""The port's quantization (`ops/quant.py` and the quantized-weight branches
of the blocks) against the JAX package's, on the CPU.

Weights are the JAX package's flux-tiny init (f32, perturbed with numpy
noise), quantized by each package and carried across by `weights/from_jax.py`;
activations are numpy draws. The int8 and int4 values of every quantizer
must equal the JAX package's exactly. The JAX side runs jitted where its
model runs jitted: XLA turns the activation quantizer's `amax / 127` into a
multiplication by the f32 reciprocal there, which the port follows, while
the weight quantizers run eagerly and divide. Tolerances: 1e-5 for one
linear, qkv projection or modulation (one f32 matmul, sums taken in another
order); 1e-4 for the forward and the two-step denoise, as for the
unquantized model (`tests/test_torch_flux.py`). In the w8a8 denoise the two
sides share their per-token int8 activations (`SharedActivationRounding`:
measured, 1 of 182,784 values lies on the other side of a rounding edge).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conceptattention_torch import VideoConceptAttentionPipeline as TorchVideoPipeline
from conceptattention_torch.models.flux import blocks as t_blocks
from conceptattention_torch.models.flux import params as t_params
from conceptattention_torch.models.video import dit as t_vdit
from conceptattention_torch.ops import attention as t_attn
from conceptattention_torch.ops import norms as t_norms
from conceptattention_torch.ops import quant as t_quant
from conceptattention_torch.ops.packing import make_img_ids as t_img_ids
from conceptattention_torch.ops.schedule import get_schedule
from conceptattention_torch.sampling import rectified_flow as t_flow
from conceptattention_torch.weights.from_jax import params_from_numpy
from conceptattention_tpu import config as j_config
from conceptattention_tpu.models.flux import blocks as j_blocks
from conceptattention_tpu.models.flux import params as j_params
from conceptattention_tpu.models.video import dit as j_vdit
from conceptattention_tpu.ops import attention as j_attn
from conceptattention_tpu.ops import norms as j_norms
from conceptattention_tpu.ops import quant as j_quant
from conceptattention_tpu.ops.packing import make_img_ids as j_img_ids
from conceptattention_tpu.pipeline import concept_pipeline as j_pipe

torch.set_num_threads(2)  # six test workers share the host's cores

ONE = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
CFG = j_config.configs["flux-tiny"].params  # the port's config has the same fields
MODES = ["w8", "w8a8", "w4"]
T, GRID, C, STEPS = 8, (4, 4), 3, 2


def rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def close(got, want, tol=TOL, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), err_msg=msg, **tol)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_paths(v, path + (k,))
    else:
        yield path, tree


@pytest.fixture(scope="module")
def flux_np():
    tree = j_params.init_flux_params(jax.random.PRNGKey(0), CFG, jnp.float32)
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(a.shape)).astype(np.float32), tree)


@pytest.fixture(scope="module")
def quantized(flux_np):
    """{mode: (port tree quantized by the port, JAX tree quantized by JAX, as numpy)}."""
    out = {}
    for mode in MODES:
        j_tree = to_np(j_quant.quantize_flux_params(
            jax.tree.map(jnp.asarray, flux_np), min_size=0, mode=mode))
        t_tree = t_quant.quantize_flux_params(params_from_numpy(flux_np), min_size=0, mode=mode)
        out[mode] = (t_tree, j_tree)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_quantize_flux_params_equals_jax(quantized, mode):
    """Every cell of both stacks: the int8 / packed int4 values bit for bit,
    the scales exactly (both divide in f32)."""
    t_tree, j_tree = quantized[mode]
    t_leaves = dict(leaves_with_paths(t_tree))
    j_leaves = dict(leaves_with_paths(j_tree))
    assert set(t_leaves) == set(j_leaves)
    n_cells = 0
    for path, want in j_leaves.items():
        got = t_leaves[path]
        if path[-1] in ("q", "qa", "q4p"):
            n_cells += 1
            assert got.dtype == torch.int8 and want.dtype == np.int8, path
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(path))
    assert n_cells == 10 + 5  # every "w" of the double and single stacks


@pytest.mark.parametrize("mode", MODES)
def test_quantize_layer_stack_odd_and_small_leaves(mode):
    """An odd input axis falls back to int8 under w4, leaves below min_size
    and 2-d leaves stay dense, act_quant spells w8a8."""
    stack = {"a": {"w": rand(0, 2, 5, 8)}, "b": {"w": rand(1, 2, 12, 6), "bias": rand(2, 2, 6)},
             "c": {"w": rand(3, 2, 3, 2)}, "d": {"w": rand(4, 12, 4)}}
    got = t_quant.quantize_layer_stack(params_from_numpy(stack), min_size=16, mode=mode)
    want = to_np(j_quant.quantize_layer_stack(jax.tree.map(jnp.asarray, stack), min_size=16,
                                              mode=mode))
    for path, w in leaves_with_paths(want):
        g = got
        for k in path:
            g = g[k]
        np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))
    assert set(got["a"]["w"]) == {"qa" if mode == "w8a8" else "q", "scale"}
    legacy = t_quant.quantize_layer_stack(params_from_numpy(stack), min_size=16, act_quant=True)
    assert set(legacy["b"]["w"]) == {"qa", "scale"}


@pytest.mark.parametrize("shape", [(3, 40, 64), (2, 1, 5, 128)])
def test_activation_quantizer_equals_jitted_jax(shape):
    x = rand(5, *shape, scale=3.0)
    x.reshape(-1, shape[-1])[0] = 0.0  # a zero row: zeros with scale 1
    got_q, got_s = t_quant.quantize_activations_per_token(torch.from_numpy(x))
    want_q, want_s = jax.jit(j_quant.quantize_activations_per_token)(jnp.asarray(x))
    assert got_q.dtype == torch.int8
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s.flatten()[0].item() == 1.0 and not got_q.reshape(-1, shape[-1])[0].any()


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_int4_pack_unpack_bit_for_bit(axis):
    q = np.random.default_rng(6).integers(-7, 8, (6, 8, 4)).astype(np.int8)
    packed = t_quant.pack_int4(torch.from_numpy(q), axis)
    want = np.asarray(j_quant.pack_int4(jnp.asarray(q), axis))
    assert packed.dtype == torch.int8
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(t_quant.unpack_int4(packed, axis).numpy(), q)
    np.testing.assert_array_equal(np.asarray(j_quant.unpack_int4(jnp.asarray(want), axis)), q)


def test_w4_cells_dequantize_like_jax():
    w = rand(7, 256, 3, 4, 8)
    t_cell = t_quant.quantize_array_w4(torch.from_numpy(w), axis=0)
    j_cell = j_quant.quantize_array_w4(jnp.asarray(w), axis=0)
    assert t_quant.w4_dims(t_cell) == j_quant.w4_dims(j_cell) == (0, 256, 128)
    np.testing.assert_array_equal(t_quant.dequantize_w4(t_cell).numpy(),
                                  np.asarray(j_quant.dequantize_w4(j_cell)))
    np.testing.assert_array_equal(t_quant.dequantize_tree({"x": t_cell})["x"].numpy(),
                                  np.asarray(j_quant.dequantize_tree({"x": j_cell})["x"]))
    assert np.abs(t_quant.dequantize_array(t_cell).numpy() - w).max() <= np.abs(w).max() / 7
    i8 = t_quant.quantize_array(torch.from_numpy(w[:, 0, 0]), torch.float32)
    np.testing.assert_array_equal(
        t_quant.dequantize_array(i8).numpy(),
        np.asarray(j_quant.dequantize_array(j_quant.quantize_array(jnp.asarray(w[:, 0, 0]),
                                                                   jnp.float32))))


def test_int8_matmul_is_exact_on_cpu():
    xq = torch.randint(-127, 128, (2, 3, 64), dtype=torch.int8)
    wq = torch.randint(-127, 128, (64, 24), dtype=torch.int8)
    got = t_quant.int8_matmul(xq, wq)
    assert got.dtype == torch.int32 and got.shape == (2, 3, 24)
    assert torch.equal(got.double(), xq.double() @ wq.double())


@pytest.mark.parametrize("mode", MODES)
def test_linear_qkv_and_modulation(quantized, mode):
    """One layer's `_linear` (MLP in), `_qkv_heads` and `modulation` on each
    cell form, against the JAX functions, jitted."""
    t_tree, j_tree = quantized[mode]
    t_p = t_params.layer(t_tree["double"], 1)
    j_p = jax.tree.map(lambda x: x[1], j_tree["double"])
    x, vec = rand(8, 2, 7, CFG.hidden_size), rand(9, 2, CFG.hidden_size)
    close(t_blocks._linear(torch.from_numpy(x), t_p["img_mlp_in"]),
          jax.jit(j_blocks._linear)(jnp.asarray(x), j_p["img_mlp_in"]), ONE, "linear")
    got = t_blocks._qkv_heads(torch.from_numpy(x), t_p["img_qkv"], t_p["img_qnorm"],
                              t_p["img_knorm"], CFG.num_heads)
    want = jax.jit(j_blocks._qkv_heads, static_argnums=4)(
        jnp.asarray(x), j_p["img_qkv"], j_p["img_qnorm"], j_p["img_knorm"], CFG.num_heads)
    for g, w, name in zip(got, want, "qkv"):
        close(g, w, ONE, name)
    t_mod = t_norms.modulation(torch.from_numpy(vec), t_p["img_mod"]["w"], t_p["img_mod"]["b"], True)
    j_mod = jax.jit(j_norms.modulation, static_argnums=3)(
        jnp.asarray(vec), j_p["img_mod"]["w"], j_p["img_mod"]["b"], True)
    for g, w in zip(t_mod, j_mod):
        for gi, wi in zip(g, w):
            close(gi, wi, ONE, "modulation")


@pytest.fixture(scope="module")
def denoise_inputs():
    img_ids = np.asarray(j_img_ids(*GRID, 1))
    return dict(
        noise=rand(20, 1, GRID[0] * GRID[1], CFG.in_channels), img_ids=img_ids,
        txt=rand(21, 1, T, CFG.context_in_dim), txt_ids=np.zeros((1, T, 3), np.float32),
        vec=rand(22, 1, CFG.vec_in_dim), concepts=rand(23, 1, C, CFG.context_in_dim),
        concept_ids=np.zeros((1, C, 3), np.float32),
        concept_vec=np.zeros((1, CFG.vec_in_dim), np.float32),
    )


class SharedActivationRounding:
    """Per-token int8 rounding is not continuous: a value within an ulp of a
    rounding edge lands on either side, and the f32 sums that the two
    packages take in another order move values by a few ulps (5e-7 of the
    row at the first w8a8 linear of flux-tiny). One such flip moves that
    token's product by one quantum, and through the tiny DiT the latents by
    2e-3 of their scale, which hides any other fault. So the JAX side reports
    its int8 activations and row scales (an ordered debug callback in its
    quantizer, in program order) and the port's quantizer hands them on in
    place of its own, after checking that its own differ from them by at
    most one step, in at most `MAX_FLIP_SHARE` of the elements."""

    MAX_FLIP_SHARE = 1e-3

    def __init__(self, monkeypatch):
        self.queue, self.flips, self.elements = [], 0, 0
        j_orig, t_orig = j_quant.quantize_activations_per_token, t_blocks.quantize_activations_per_token

        def j_record(x):
            q, s = j_orig(x)
            jax.debug.callback(lambda q, s: self.queue.append((np.asarray(q), np.asarray(s))),
                               q, s, ordered=True)
            return q, s

        def t_replay(x):
            q, s = t_orig(x)
            jq, js = self.queue.pop(0)
            assert jq.shape == tuple(q.shape), (jq.shape, q.shape)
            step = np.abs(q.numpy().astype(np.int32) - jq)
            assert step.max() <= 1
            self.flips += int(np.count_nonzero(step))
            self.elements += step.size
            return torch.from_numpy(jq.copy()), torch.from_numpy(js.copy())

        monkeypatch.setattr(j_quant, "quantize_activations_per_token", j_record)
        monkeypatch.setattr(t_blocks, "quantize_activations_per_token", t_replay)

    def check(self):
        assert not self.queue and self.elements
        assert self.flips <= self.MAX_FLIP_SHARE * self.elements, (self.flips, self.elements)


def run_denoise(t_tree, j_tree, inputs, int8_qk, monkeypatch):
    """Both samplers on the same injected latents: two Euler steps of the
    quantized DiT with the concept stream. The JAX side runs first (a fresh
    jit, so the quantizer is traced with its callback); with w8a8 cells the
    port takes its int8 activations (`SharedActivationRounding`)."""
    shared = SharedActivationRounding(monkeypatch)
    schedule = get_schedule(STEPS, GRID[0] * GRID[1], shift=False)
    spec = j_attn.ConceptAttentionSpec(
        backend="pallas_interpret" if int8_qk else "xla", int8_qk=int8_qk)
    j_in = {k: jnp.asarray(v) for k, v in inputs.items()}
    generate = jax.jit(lambda *a: j_pipe._generate_latents.__wrapped__(
        *a[:1], CFG, *a[1:], spec, CFG.guidance_embed))
    j_lat, j_sal = generate(
        j_tree, j_in["noise"], j_in["img_ids"], j_in["txt"], j_in["txt_ids"], j_in["vec"],
        j_in["concepts"], j_in["concept_ids"], j_in["concept_vec"], jnp.asarray(schedule), 0.0)
    jax.effects_barrier()
    t_in = {k: torch.from_numpy(np.array(v)) for k, v in inputs.items()}
    t_lat, t_sal = t_flow.denoise(
        t_tree, CFG, t_in["noise"], t_in["img_ids"], t_in["txt"], t_in["txt_ids"], t_in["vec"],
        schedule, 0.0, concepts=t_in["concepts"], concept_ids=t_in["concept_ids"],
        concept_vec=t_in["concept_vec"], spec=t_attn.ConceptAttentionSpec(int8_qk=int8_qk))
    return (t_lat, t_sal), (j_lat, j_sal), shared


@pytest.mark.parametrize("mode,int8_qk", [("w8", False), ("w8a8", False), ("w4", False),
                                          ("w8a8", True)])
def test_quantized_denoise_matches_jax(quantized, denoise_inputs, monkeypatch, mode, int8_qk):
    """The quantized DiT through the port's sampler against JAX's jitted
    `_generate_latents`; with `int8_qk` the JAX side runs its Pallas kernel
    in interpret mode and the port K1b's plain version."""
    t_tree, j_tree = quantized[mode]
    (t_lat, t_sal), (j_lat, j_sal), shared = run_denoise(
        params_from_numpy(j_tree), j_tree, denoise_inputs, int8_qk, monkeypatch)
    if mode == "w8a8":
        shared.check()
    close(t_lat, j_lat, msg="latents")
    for tap in ("output", "cross_attention"):
        assert t_sal[tap].shape == (STEPS, CFG.depth, 1, C, GRID[0] * GRID[1])
        close(t_sal[tap], j_sal[tap], msg=tap)


def test_from_jax_keeps_integer_leaves(quantized):
    """dtype= casts floating leaves only: int8 and packed int4 cells stay int8."""
    for mode in ("w8a8", "w4"):
        tree = params_from_numpy(quantized[mode][1], dtype=torch.bfloat16)
        cell = tree["single"]["qkv"]["w"]
        key = "q4p" if mode == "w4" else "qa"
        assert cell[key].dtype == torch.int8
        np.testing.assert_array_equal(cell[key].numpy(), quantized[mode][1]["single"]["qkv"]["w"][key])
        assert tree["single"]["qkv"]["b"].dtype == torch.bfloat16


@pytest.mark.parametrize("mode", MODES)
def test_random_quantized_init(mode):
    """The random already-quantized init has the JAX init's tree, shapes and
    dtypes, scales that give the bf16 init's std, and drives a forward."""
    from conceptattention_torch.models.flux.dit import flux_forward

    t_tree = t_quant.init_flux_params_quantized(torch.Generator().manual_seed(0), CFG,
                                                torch.float32, mode=mode)
    j_tree = j_quant.init_flux_params_quantized(jax.random.PRNGKey(0), CFG, jnp.float32, mode=mode)
    t_meta = {p: (tuple(x.shape), str(x.dtype).split(".")[-1]) for p, x in leaves_with_paths(t_tree)}
    j_meta = {p: (tuple(x.shape), str(x.dtype)) for p, x in leaves_with_paths(to_np(j_tree))}
    assert t_meta == j_meta
    w = t_quant.dequantize_array(t_tree["double"]["img_mlp_in"]["w"])
    assert abs(w.float().std().item() * CFG.hidden_size**0.5 - 1.0) < 0.05
    inputs = {k: torch.from_numpy(rand(30 + i, *s)) for i, (k, s) in enumerate(
        [("img", (1, 16, CFG.in_channels)), ("txt", (1, T, CFG.context_in_dim)),
         ("y", (1, CFG.vec_in_dim))])}
    pred, _ = flux_forward(
        t_tree, CFG, img=inputs["img"], img_ids=t_img_ids(4, 4, 1), txt=inputs["txt"],
        txt_ids=torch.zeros(1, T, 3), timesteps=torch.tensor([0.5]), y=inputs["y"])
    assert pred.shape == (1, 16, CFG.in_channels) and torch.isfinite(pred).all()


VIDEO_TINY = dict(num_attention_heads=2, attention_head_dim=16, in_channels=4, out_channels=4,
                  time_embed_dim=8, text_embed_dim=16, num_layers=2, sample_width=8,
                  sample_height=8, sample_frames=9, patch_size=2, max_text_seq_length=6,
                  use_rotary_positional_embeddings=True)


@pytest.mark.parametrize("mode", MODES)
def test_random_quantized_video_init(mode):
    """The CogVideoX counterpart of `test_random_quantized_init`: the JAX
    init's tree, shapes and dtypes, and a finite forward."""
    cfg = dict(VIDEO_TINY, attention_head_dim=64)  # MLP layers of 2**16 elements
    t_tree = t_quant.init_video_dit_params_quantized(
        torch.Generator().manual_seed(0), t_vdit.CogVideoXConfig(**cfg), torch.float32, mode=mode)
    j_tree = j_quant.init_video_dit_params_quantized(
        jax.random.PRNGKey(0), j_vdit.CogVideoXConfig(**cfg), jnp.float32, mode=mode)
    t_meta = {p: (tuple(x.shape), str(x.dtype).split(".")[-1]) for p, x in leaves_with_paths(t_tree)}
    j_meta = {p: (tuple(x.shape), str(x.dtype)) for p, x in leaves_with_paths(to_np(j_tree))}
    assert t_meta == j_meta
    assert set(t_tree["blocks"]["ff_in"]["w"]) == (
        {"q4p", "gscale"} if mode == "w4" else {"qa" if mode == "w8a8" else "q", "scale"})
    pred, _ = t_vdit.video_dit_forward(
        t_tree, t_vdit.CogVideoXConfig(**cfg), torch.from_numpy(rand(43, 2, 3, 4, 8, 8)),
        torch.from_numpy(rand(44, 2, 6, 16)), torch.tensor([999.0, 500.0]))
    assert torch.isfinite(pred).all()


@pytest.mark.parametrize("mode", MODES)
def test_quantized_video_forward_matches_jax(mode, monkeypatch):
    """The tiny CogVideoX DiT with its blocks quantized by each package (the
    values equal), forward against the JAX forward, jitted. The JAX side
    runs first, in a fresh jit; with w8a8 cells the port takes its int8
    activations (`SharedActivationRounding`): both DiTs quantize through the
    flux blocks' `_linear`, which looks the quantizer up where it is patched."""
    shared = SharedActivationRounding(monkeypatch)
    t_cfg, j_cfg = t_vdit.CogVideoXConfig(**VIDEO_TINY), j_vdit.CogVideoXConfig(**VIDEO_TINY)
    dense = j_vdit.init_video_dit_params(jax.random.PRNGKey(0), j_cfg, jnp.float32)
    j_tree = j_quant.quantize_video_dit_params(dense, min_size=0, mode=mode)
    t_tree = t_quant.quantize_video_dit_params(params_from_numpy(to_np(dense)), min_size=0,
                                               mode=mode)
    for path, want in leaves_with_paths(to_np(j_tree)):
        got = t_tree
        for k in path:
            got = got[k]
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(path))
    args = dict(video=rand(40, 2, 3, 4, 8, 8), text=rand(41, 2, 6, 16),
                timestep=np.array([999.0, 500.0], np.float32))
    concepts = rand(42, 2, 6, 16)
    fwd = jax.jit(lambda tree, *a, **kw: j_vdit.video_dit_forward(tree, j_cfg, *a, **kw),
                  static_argnames=("spec",))
    want_pred, want_sal = fwd(j_tree, *(jnp.asarray(a) for a in args.values()),
                              concepts=jnp.asarray(concepts), spec=j_attn.ConceptAttentionSpec())
    jax.effects_barrier()
    got_pred, got_sal = t_vdit.video_dit_forward(
        t_tree, t_cfg, *(torch.from_numpy(a) for a in args.values()),
        concepts=torch.from_numpy(concepts))
    if mode == "w8a8":
        shared.check()
    close(got_pred, want_pred, msg="pred")
    for tap in ("output", "cross_attention"):
        close(got_sal[tap], want_sal[tap], msg=tap)


def test_video_pipeline_quantize_option():
    """`quantize=` quantizes the DiT's stacked blocks with the default size
    floor (2**16 elements), as the JAX pipeline's constructor does; the
    embedders and smaller leaves stay dense. Head dim 64 puts the qkv and MLP
    stacks above the floor."""
    cfg = t_vdit.CogVideoXConfig(**dict(VIDEO_TINY, attention_head_dim=64))
    dense = TorchVideoPipeline(cfg=cfg, dtype=torch.float32, device="cpu")
    pipe = TorchVideoPipeline(cfg=cfg, dtype=torch.float32, device="cpu", quantize="w8a8")
    assert set(pipe.params["blocks"]["qkv"]["w"]) == {"qa", "scale"}
    assert set(pipe.params["blocks"]["ff_in"]["w"]) == {"qa", "scale"}
    want = t_quant.quantize_video_dit_params(dense.params, mode="w8a8")
    for path, w in leaves_with_paths(want):
        got = pipe.params
        for k in path:
            got = got[k]
        assert torch.equal(got, w), path
    with pytest.raises(ValueError, match="quantize"):
        TorchVideoPipeline(cfg=cfg, dtype=torch.float32, device="cpu", quantize="w3")
    out = pipe.generate_video("a dog", ["dog"], num_frames=3, height=8, width=8,
                              num_inference_steps=2)
    assert out.concept_heatmaps.shape == (1, 3, 4, 4) and np.isfinite(out.concept_heatmaps).all()


@pytest.mark.parametrize("source", ["quantize_flux_params", "init_flux_params_quantized",
                                    "pipeline params="])
def test_w8a8_layers_are_column_major_views(flux_np, quantized, source):
    """Each layer of a w8a8 stack, flattened to [in, out], is a column-major
    view: the layout the card's int8 GEMM requires (a row-major weight would
    send it to a fallback GEMM, so `int8_matmul` refuses one there). A tree
    passed in to the pipeline, such as the JAX package's row-major one, is
    laid out so with its values kept, and laying it out again copies nothing."""
    if source == "quantize_flux_params":
        tree = t_quant.quantize_flux_params(params_from_numpy(flux_np), min_size=0, mode="w8a8")
    elif source == "init_flux_params_quantized":
        tree = t_quant.init_flux_params_quantized(torch.Generator().manual_seed(0), CFG,
                                                  torch.float32, mode="w8a8")
    else:
        from conceptattention_torch import ConceptAttentionFluxPipeline

        given = params_from_numpy(quantized["w8a8"][1])
        assert given["single"]["mlp_in"]["w"]["qa"].is_contiguous()  # row-major per layer
        tree = ConceptAttentionFluxPipeline("flux-tiny", dtype=torch.float32, device="cpu",
                                            params=given).params
        for path, want in leaves_with_paths(given):
            got = tree
            for k in path:
                got = got[k]
            assert torch.equal(got, want), path
    for stack, name in (("double", "img_mlp_in"), ("single", "mlp_in")):  # 2**16+ weights
        qa = t_params.layer(tree[stack], 1)[name]["w"]["qa"]
        flat = qa.reshape(qa.shape[0], -1)
        assert flat.stride() == (1, qa.shape[0]) and flat.data_ptr() == qa.data_ptr()
        cell = tree[stack][name]["w"]
        assert t_quant.int8_gemm_layout(cell)["qa"].data_ptr() == cell["qa"].data_ptr()
