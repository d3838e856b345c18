"""The port's training step and LoRA fine-tuning against the JAX package's.

Both packages take the same weights (the JAX init, carried across by
`weights/from_jax.py`), the same batch and the same random draws: JAX's
t and eps are drawn from its key in the test, as `flow_matching_loss`
draws them, and passed to the port's functions. Configs are the JAX tests'
own: the TINY config of `tests/test_train_loop.py` for the full-parameter
step, flux-tiny (`tests/test_lora.py`'s CFG) for LoRA; f32 on the CPU.

Tolerances: the loss to 1e-5 relative; gradients to 1e-4 of each tree's
largest gradient (a few hundred f32 reductions taken in another order, then
the backward through them); parameters after 1 and 3 AdamW updates at lr
1e-3 to 1e-6 absolute, leaving out the elements whose first gradient is
below 1e-6 in magnitude (0.2% of them here; the test prints the count and
holds it under 1%): the two packages' gradients there differ by rounding of
a few 1e-8, a tenth of their size or more, and Adam's g / (sqrt(v) + 1e-8)
turns that into a step difference of up to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conceptattention_torch.config import FluxConfig as TFluxConfig
from conceptattention_torch.config import configs as t_configs
from conceptattention_torch.kernels import conv3x3 as t_conv
from conceptattention_torch.kernels import flash_saliency as t_fs
from conceptattention_torch.kernels import ring_rdma as t_ring
from conceptattention_torch.models.flux.dit import flux_forward as t_forward
from conceptattention_torch.models.flux.params import tree_leaves, tree_map
from conceptattention_torch.ops import quant as t_quant
from conceptattention_torch.ops.attention import ConceptAttentionSpec
from conceptattention_torch.training import flow_matching_loss as t_loss
from conceptattention_torch.training import init_train_state as t_init_state
from conceptattention_torch.training import make_train_step as t_make_step
from conceptattention_torch.training import lora as t_tlora
from conceptattention_torch.weights import lora as t_wlora
from conceptattention_torch.weights.from_jax import lora_from_numpy, params_from_numpy
from conceptattention_tpu.config import FluxConfig as JFluxConfig
from conceptattention_tpu.config import configs as j_configs
from conceptattention_tpu.models.flux.params import init_flux_params
from conceptattention_tpu.ops import quant as j_quant
from conceptattention_tpu.ops.packing import make_img_ids
from conceptattention_tpu.training import lora as j_tlora
from conceptattention_tpu.training.train_step import flow_matching_loss as j_loss
from conceptattention_tpu.training.train_step import init_train_state as j_init_state
from conceptattention_tpu.training.train_step import make_train_step as j_make_step
from conceptattention_tpu.weights import lora as j_wlora

torch.set_num_threads(2)  # six test workers share the host's cores

TINY_KW = dict(in_channels=4, vec_in_dim=8, context_in_dim=8, hidden_size=32, mlp_ratio=2.0,
               num_heads=2, depth=2, depth_single_blocks=1, axes_dim=(4, 6, 6), qkv_bias=True,
               guidance_embed=False)
J_TINY, T_TINY = JFluxConfig(**TINY_KW), TFluxConfig(**TINY_KW)
J_CFG, T_CFG = j_configs["flux-tiny"].params, t_configs["flux-tiny"].params
R = 4
LOSS_RTOL = 1e-5
GRAD_FRACTION = 1e-4
PARAM_ATOL = 1e-6
SMALL_GRAD = 1e-6


def jax_batch(seed, cfg, b=2, p=16, t=4):
    ks = jax.random.split(jax.random.PRNGKey(seed), 4)
    return {
        "img": jax.random.normal(ks[0], (b, p, cfg.in_channels)),
        "img_ids": make_img_ids(4, 4, b),
        "txt": jax.random.normal(ks[1], (b, t, cfg.context_in_dim)),
        "txt_ids": jnp.zeros((b, t, 3)),
        "y": jax.random.normal(ks[2], (b, cfg.vec_in_dim)),
    }


def to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def jax_draws(key, x_shape):
    """(t, eps) as the JAX `flow_matching_loss` draws them from `key`."""
    t_key, eps_key = jax.random.split(key)
    t = jax.nn.sigmoid(jax.random.normal(t_key, (x_shape[0],)))
    eps = jax.random.normal(eps_key, x_shape, jnp.float32)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(eps))


def flat(tree):
    return np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree.leaves(tree)])


def t_flat(tensors):
    return np.concatenate([t.detach().double().numpy().ravel() for t in tensors])


def trainable(tree):
    return tree_map(lambda x: x.clone().requires_grad_(True), tree)


J_GRAD = jax.jit(jax.value_and_grad(j_loss), static_argnums=1)
J_LORA_GRAD = jax.jit(jax.value_and_grad(j_tlora.lora_flow_matching_loss), static_argnums=2)


@pytest.fixture(scope="module")
def tiny():
    """TINY f32 weights (JAX init) and a batch, in both packages."""
    j = init_flux_params(jax.random.PRNGKey(0), J_TINY, jnp.float32)
    batch = jax_batch(8, J_TINY)
    return j, batch, to_torch(batch)


def test_flow_matching_loss_and_gradients_match_jax(tiny):
    j_params, j_batch, t_batch = tiny
    key = jax.random.PRNGKey(9)
    loss, grads = J_GRAD(j_params, J_TINY, j_batch, key)
    params = trainable(to_torch(j_params))
    t, eps = jax_draws(key, j_batch["img"].shape)
    got = t_loss(params, T_TINY, t_batch, t=t, eps=eps)
    got_grads = torch.autograd.grad(got, tree_leaves(params))
    assert abs(got.item() - float(loss)) <= LOSS_RTOL * abs(float(loss))
    want = flat(grads)
    diff = np.abs(t_flat(got_grads) - want).max()
    assert diff <= GRAD_FRACTION * np.abs(want).max(), diff


def test_loss_draws_t_then_eps_from_the_generator(tiny):
    """Without t / eps the loss draws them from its generator, t first: the
    same generator state gives the same loss as the draws passed in."""
    _, _, t_batch = tiny
    params = to_torch(init_flux_params(jax.random.PRNGKey(0), J_TINY, jnp.float32))
    x = t_batch["img"]
    g = torch.Generator().manual_seed(3)
    t = torch.sigmoid(torch.randn(x.shape[0], generator=g))
    eps = torch.randn(x.shape, generator=g)
    with torch.no_grad():
        drawn = t_loss(params, T_TINY, t_batch, torch.Generator().manual_seed(3))
        passed = t_loss(params, T_TINY, t_batch, t=t, eps=eps)
    assert torch.equal(drawn, passed)


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_updates_match_jax(tiny, steps):
    j_params, j_batch, t_batch = tiny
    tx, opt_state = j_init_state(j_params, learning_rate=1e-3)
    j_step = j_make_step(J_TINY, tx, donate=False)
    params = to_torch(j_params)
    opt = t_init_state(params, learning_rate=1e-3)
    assert opt.defaults["weight_decay"] == 0.0
    t_step = t_make_step(T_TINY, opt)
    first_grads = None
    for i in range(steps):
        key = jax.random.PRNGKey(100 + i)
        if first_grads is None:
            first_grads = flat(J_GRAD(j_params, J_TINY, j_batch, key)[1])
        j_params, opt_state, j_l = j_step(j_params, opt_state, j_batch, key)
        t, eps = jax_draws(key, j_batch["img"].shape)
        t_l = t_step(params, t_batch, t=t, eps=eps)
        assert abs(t_l.item() - float(j_l)) <= LOSS_RTOL * abs(float(j_l))
    want, got = flat(j_params), t_flat(tree_leaves(params))
    keep = np.abs(first_grads) >= SMALL_GRAD
    print(f"{(~keep).sum()} of {keep.size} elements left out (first |grad| < {SMALL_GRAD})")
    assert (~keep).sum() <= 0.01 * keep.size
    assert np.abs(got - want)[keep].max() <= PARAM_ATOL


def test_mesh_arguments_raise():
    """A mesh whose layout the parameters do not have, or shardings without
    a mesh, raise when the step runs (the FSDP / TP step itself is held to
    JAX's in `tests/test_torch_parallel.py`)."""
    from conceptattention_torch.parallel import make_mesh

    params = {"w": torch.zeros(2, 2, requires_grad=True)}
    opt = torch.optim.AdamW([params["w"]])
    mesh = make_mesh(data=2, devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="laid out over"):
        t_make_step(T_TINY, opt, mesh=mesh)(params, {})
    with pytest.raises(ValueError, match="need a mesh"):
        t_make_step(T_TINY, opt, param_sharding={})(params, {})


def test_remat_gives_the_same_loss_and_gradients(tiny):
    j_params, j_batch, t_batch = tiny
    t, eps = jax_draws(jax.random.PRNGKey(4), j_batch["img"].shape)
    outs = []
    for remat in (False, True):
        params = trainable(to_torch(j_params))
        x = t_batch["img"]
        x_t = t[:, None, None] * eps + (1 - t[:, None, None]) * x
        pred, _ = t_forward(params, T_TINY, img=x_t, img_ids=t_batch["img_ids"],
                            txt=t_batch["txt"], txt_ids=t_batch["txt_ids"], timesteps=t,
                            y=t_batch["y"], spec=ConceptAttentionSpec(backend="sdpa"),
                            remat=remat)
        loss = torch.mean(torch.square(pred - (eps - x)))
        outs.append((loss, torch.autograd.grad(loss, tree_leaves(params))))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))


def test_fused_backend_refuses_autograd(tiny):
    """The kernels have no backward: a forward on the default (fused)
    backend with a parameter that requires grad raises, and runs under
    no_grad; training's spec (sdpa) takes gradients."""
    j_params, _, t_batch = tiny
    params = trainable(to_torch(j_params))
    kw = dict(img=t_batch["img"], img_ids=t_batch["img_ids"], txt=t_batch["txt"],
              txt_ids=t_batch["txt_ids"], timesteps=torch.full((2,), 0.5), y=t_batch["y"])
    with pytest.raises(RuntimeError, match="no backward.*sdpa"):
        t_forward(params, T_TINY, **kw)
    with torch.no_grad():
        pred, _ = t_forward(params, T_TINY, **kw)
    assert pred.shape == t_batch["img"].shape
    pred, _ = t_forward(params, T_TINY, spec=ConceptAttentionSpec(backend="sdpa"), **kw)
    assert pred.grad_fn is not None


def _flash_args(requires_grad):
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 12, 64, generator=gen).requires_grad_(requires_grad)
               for _ in range(3))
    cos, sin = torch.ones(1, 12, 64), torch.zeros(1, 12, 64)
    return q, k, v, cos, sin


def _kernel_calls():
    """(name, call(requires_grad)) for every kernel entry."""

    def flash(fn, **kw):
        def call(rg):
            q, k, v, cos, sin = _flash_args(rg)
            return fn(q, k, v, 4, 6, 2, rope_cos=cos, rope_sin=sin, **kw)
        return call

    def paired(rg):
        q, k, v, cos, sin = _flash_args(rg)
        return t_fs.fused_concept_flash_attention_paired(q, k, v, cos, sin, 4, 6, 2)

    def conv(fn):
        def call(rg):
            gen = torch.Generator().manual_seed(1)
            x = torch.randn(1, 8, 8, 32, generator=gen).requires_grad_(rg)
            return fn(x, torch.randn(3, 3, 32, 8, generator=gen), torch.zeros(8))
        return call

    def ring(rg):
        q, k, v, _, _ = _flash_args(rg)
        return t_ring.ring_attention_rdma(list(q.chunk(2, 2)), list(k.chunk(2, 2)),
                                          list(v.chunk(2, 2)))

    def ring_step(rg):
        q, k, v, _, _ = _flash_args(rg)
        out = torch.empty_like(q)
        return t_ring.ring_step([q], [k], [v], [None], [None], [out], [0], 1, 0)

    return [
        ("fused_concept_flash_attention", flash(t_fs.fused_concept_flash_attention)),
        ("fused_concept_flash_attention_hopper", flash(t_fs.fused_concept_flash_attention_hopper)),
        ("fused_concept_flash_attention_int8", flash(t_fs.fused_concept_flash_attention_int8)),
        ("fused_concept_flash_attention_int8_hopper",
         flash(t_fs.fused_concept_flash_attention_int8_hopper)),
        ("fused_concept_flash_attention_paired", paired),
        ("conv3x3_same", conv(t_conv.conv3x3_same)),
        ("conv3x3_same_generic", conv(t_conv.conv3x3_same_generic)),
        ("conv3x3_same_hopper", conv(t_conv.conv3x3_same_hopper)),
        ("ring_attention_rdma", ring),
        ("ring_step", ring_step),
    ]


@pytest.mark.parametrize("name,call", _kernel_calls(), ids=[n for n, _ in _kernel_calls()])
def test_kernel_entries_refuse_autograd(name, call):
    """Every kernel entry raises on the CPU too (no quiet switch to its
    plain version), and runs with autograd off or without such inputs."""
    with pytest.raises(RuntimeError, match=f"{name} has no backward"):
        call(True)
    with torch.no_grad():
        call(True)
    call(False)


# ---------------------------------------------------------------------------
# LoRA

@pytest.fixture(scope="module")
def lora_base():
    """flux-tiny f32 weights, an adapter moved off b = 0 (the JAX test's
    +0.02), a batch and a key, as `tests/test_lora.py` builds them."""
    params = init_flux_params(jax.random.PRNGKey(6), J_CFG, jnp.float32)
    lora = j_tlora.init_lora_params(jax.random.PRNGKey(7), params, rank=R)
    lora = jax.tree.map(lambda x: x + 0.02 if x.ndim == 3 else x, lora)
    return params, lora, jax_batch(8, J_CFG, b=1), jax.random.PRNGKey(9)


def port_lora_grads(lora, base, batch, key):
    factors = trainable(lora_from_numpy(jax.tree.map(np.asarray, lora)))
    t, eps = jax_draws(key, batch["img"].shape)
    loss = t_tlora.lora_flow_matching_loss(factors, base, T_CFG, to_torch(batch), t=t, eps=eps)
    return loss, torch.autograd.grad(loss, tree_leaves(factors))


@pytest.mark.parametrize("mode", [None, "w8", "w8a8", "w4"])
def test_lora_gradients_match_jax(lora_base, mode):
    params, lora, batch, key = lora_base
    base = params if mode is None else j_quant.quantize_flux_params(
        params, min_size=0, mode=mode, group_size=8)
    loss, grads = J_LORA_GRAD(lora, base, J_CFG, batch, key)
    t_base = to_torch(base)
    if mode == "w8a8":
        t_base = t_quant.int8_gemm_layout(t_base)
    got_loss, got = port_lora_grads(lora, t_base, batch, key)
    assert abs(got_loss.item() - float(loss)) <= LOSS_RTOL * abs(float(loss))
    want = flat(grads)
    diff = np.abs(t_flat(got) - want).max()
    assert diff <= GRAD_FRACTION * np.abs(want).max(), diff


@pytest.mark.parametrize("mode", ["w8", "w8a8", "w4"])
def test_lora_quantized_base_gradients_track_fp(lora_base, mode):
    """The JAX test's own limits on the port: adapter gradients on a
    quantized base are dense and point the way the f32 base's do."""
    params, lora, batch, key = lora_base
    q = t_quant.quantize_flux_params(to_torch(params), min_size=0, mode=mode, group_size=8)
    if mode == "w8a8":
        q = t_quant.int8_gemm_layout(q)
    a = t_flat(port_lora_grads(lora, to_torch(params), batch, key)[1])
    b = t_flat(port_lora_grads(lora, q, batch, key)[1])
    assert (np.abs(b) > 0).mean() > 0.9, "quantized-base grad is sparse"
    cos = (a @ b) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)
    assert cos > 0.95, f"grad cosine vs fp base: {cos:.3f}"


def test_lora_train_step_decreases_loss_base_frozen():
    """Port of the JAX test: b = 0 is the base model, eight steps on a fixed
    batch and draw lower the loss, b moves, and the base neither moves nor
    takes a gradient."""
    base = to_torch(init_flux_params(jax.random.PRNGKey(6), J_CFG, jnp.float32))
    before = [x.clone() for x in tree_leaves(base)]
    lora = t_tlora.init_lora_params(torch.Generator().manual_seed(7), base, rank=R)
    assert set(lora["double"]) == set(t_tlora.DEFAULT_DOUBLE_TARGETS)
    assert set(lora["single"]) == set(t_tlora.DEFAULT_SINGLE_TARGETS)
    assert all(torch.equal(f["b"], torch.zeros_like(f["b"]))
               for stack in lora.values() for f in stack.values())
    batch = to_torch(jax_batch(8, J_CFG))
    with torch.no_grad():
        l_base = t_loss(base, T_CFG, batch, torch.Generator().manual_seed(9))
        l_lora = t_tlora.lora_flow_matching_loss(lora, base, T_CFG, batch,
                                                 torch.Generator().manual_seed(9))
    assert abs(l_base.item() - l_lora.item()) < 1e-5
    opt = t_init_state(lora, learning_rate=1e-3)
    step = t_tlora.make_lora_train_step(T_CFG, opt)
    losses = [step(lora, base, batch, torch.Generator().manual_seed(9)).item()
              for _ in range(8)]
    assert losses[-1] < losses[0]
    assert lora["double"]["img_qkv"]["b"].abs().max().item() > 0
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(base)))
    assert all(not x.requires_grad and x.grad is None for x in tree_leaves(base))


def test_init_lora_params_dims_and_scale():
    """Every default target of flux-tiny, dense and quantized alike (w4's
    packed input axis included): a [depth, in, r] ~ N(0, 1/in), b zero."""
    params = to_torch(init_flux_params(jax.random.PRNGKey(6), J_CFG, jnp.float32))
    want = j_tlora.init_lora_params(jax.random.PRNGKey(7), init_flux_params(
        jax.random.PRNGKey(6), J_CFG, jnp.float32), rank=R)
    for mode in (None, "w8", "w4"):
        tree = params if mode is None else t_quant.quantize_flux_params(
            params, min_size=0, mode=mode, group_size=8)
        got = t_tlora.init_lora_params(torch.Generator().manual_seed(1), tree, rank=R)
        for stack in ("double", "single"):
            assert set(got[stack]) == set(want[stack])
            for leaf, f in got[stack].items():
                assert f["a"].shape == want[stack][leaf]["a"].shape
                assert f["b"].shape == want[stack][leaf]["b"].shape
                assert f["a"].dtype == torch.float32
                d_in = f["a"].shape[1]
                assert abs(f["a"].std().item() * d_in**0.5 - 1) < 0.2


def test_export_matches_jax_and_converts_back_to_the_same_merge():
    params = init_flux_params(jax.random.PRNGKey(10), J_CFG, jnp.float32)
    lora = j_tlora.init_lora_params(jax.random.PRNGKey(11), params, rank=R)
    lora = jax.tree.map(
        lambda x: x + 0.01 * jax.random.normal(jax.random.PRNGKey(12), x.shape), lora)
    want = j_tlora.export_lora_state_dict(lora)
    t_lora_tree = lora_from_numpy(jax.tree.map(np.asarray, lora))
    got = t_tlora.export_lora_state_dict(t_lora_tree)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)
    back = t_wlora.convert_lora_state_dict(got, T_CFG)
    t_params = to_torch(params)
    m1 = t_wlora.merge_lora(t_params, t_lora_tree)
    m2 = t_wlora.merge_lora(t_params, back)
    for stack in ("double", "single"):
        for leaf in t_lora_tree[stack]:
            assert torch.equal(m1[stack][leaf]["w"], m2[stack][leaf]["w"]), f"{stack}.{leaf}"
    j_back = j_wlora.convert_lora_state_dict(want, J_CFG)
    for stack in ("double", "single"):
        for leaf, f in back[stack].items():
            for part in ("a", "b"):
                np.testing.assert_array_equal(f[part].numpy(), np.asarray(j_back[stack][leaf][part]))


def test_dense_weights_of_another_dtype_promote_as_in_jax():
    """A dense f32 weight (the training merge over a quantized base) met by
    bf16 activations: the blocks' linears compute in the promoted dtype, as
    JAX's bf16 @ f32 does; same-dtype products are untouched."""
    from conceptattention_torch.models.flux import blocks as t_blocks

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 5, 16), np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((16, 3, 2, 4), np.float32))
    b = torch.from_numpy(rng.standard_normal((24,), np.float32)).bfloat16()
    want = jnp.asarray(x.float().numpy(), jnp.bfloat16) @ jnp.asarray(w.reshape(16, 24).numpy())
    assert want.dtype == jnp.float32
    got = t_blocks._linear(x, {"w": w.reshape(16, 24), "b": b})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want) + b.float().numpy(), rtol=1e-6,
                               atol=1e-6)
    q, k, v = t_blocks._qkv_heads(x, {"w": w}, torch.ones(4), torch.ones(4), 2)
    assert v.dtype == torch.float32
    np.testing.assert_allclose(v.numpy(), np.asarray(want).reshape(2, 5, 3, 2, 4)[:, :, 2]
                               .transpose(0, 2, 1, 3), rtol=1e-6, atol=1e-6)
    same = t_blocks._linear(x, {"w": w.reshape(16, 24).bfloat16()})
    assert same.dtype == torch.bfloat16 and torch.equal(same, x @ w.reshape(16, 24).bfloat16())
