"""The port's parallelism against the JAX package's, on the CPU.

The JAX side runs on its 8 virtual CPU devices (`tests/conftest.py`); the
port's meshes are `make_mesh(..., devices=[cpu] * n)`, the same shapes, n
ranks on one device. Inputs and weights are numpy draws or JAX inits handed
across by `weights/from_jax.py`. Tolerances are the JAX tests' own
(`tests/test_sharding.py`, `test_fsdp.py`, `test_pipeline_parallel.py`,
`test_moe.py`, `test_context_parallel.py`): rtol 5e-4 / atol 5e-5 for the
sharded forwards, 3e-5 for the pipelined and tensor-parallel blocks, 2e-5
for the MLP stacks and MoE, 1e-5 relative for the FSDP loss and 1e-4 for
its parameters after an AdamW step, rtol 2e-3 / atol 2e-4 for the dp x sp
x tp forward. The port's own layouts are held to its dense functions at
1e-5 (f32, sums taken in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

from conceptattention_torch import ConceptAttentionFluxPipeline as TorchPipeline
from conceptattention_torch.config import FluxConfig as TFluxConfig
from conceptattention_torch.config import configs as t_configs
from conceptattention_torch.models.flux import blocks as t_blocks
from conceptattention_torch.models.flux.dit import flux_forward as t_forward
from conceptattention_torch.models.flux.params import tree_leaves, tree_map
from conceptattention_torch.ops import quant as t_quant
from conceptattention_torch.ops.attention import ConceptAttentionSpec as TSpec
from conceptattention_torch.parallel import collectives as t_coll
from conceptattention_torch.parallel import fsdp as t_fsdp
from conceptattention_torch.parallel import make_mesh as t_make_mesh
from conceptattention_torch.parallel import moe as t_moe
from conceptattention_torch.parallel import sharding as t_sharding
from conceptattention_torch.parallel.pipeline import pipeline_apply as t_pipeline_apply
from conceptattention_torch.training import init_train_state as t_init_state
from conceptattention_torch.training import make_train_step as t_make_step
from conceptattention_torch.training.train_loop import TrainConfig as TTrainConfig
from conceptattention_torch.training.train_loop import train_loop as t_train_loop
from conceptattention_torch.weights.from_jax import (
    moe_params_from_numpy,
    params_from_numpy,
    stacked_params_from_numpy,
)
from conceptattention_tpu.config import FluxConfig as JFluxConfig
from conceptattention_tpu.config import configs as j_configs
from conceptattention_tpu.models.flux import blocks as j_blocks
from conceptattention_tpu.models.flux.dit import flux_forward as j_forward
from conceptattention_tpu.models.flux.params import init_flux_params
from conceptattention_tpu.ops import quant as j_quant
from conceptattention_tpu.ops.attention import ConceptAttentionSpec as JSpec
from conceptattention_tpu.ops.packing import make_img_ids
from conceptattention_tpu.ops.rope import embed_nd as j_embed_nd
from conceptattention_tpu.parallel import fsdp as j_fsdp
from conceptattention_tpu.parallel import moe as j_moe
from conceptattention_tpu.parallel import sharding as j_sharding
from conceptattention_tpu.parallel._compat import shard_map_compat
from conceptattention_tpu.parallel.mesh import make_mesh as j_make_mesh
from conceptattention_tpu.parallel.pipeline import pipeline_apply as j_pipeline_apply
from conceptattention_tpu.training.train_step import init_train_state as j_init_state
from conceptattention_tpu.training.train_step import make_train_step as j_make_step

torch.set_num_threads(2)  # six test workers share the host's cores

CPU = torch.device("cpu")
FWD = dict(rtol=5e-4, atol=5e-5)
BLOCK = dict(rtol=3e-5, atol=3e-5)
MLP = dict(rtol=2e-5, atol=2e-5)
COMPOSED = dict(rtol=2e-3, atol=2e-4)
OWN = dict(rtol=1e-5, atol=1e-5)
J_CFG, T_CFG = j_configs["flux-tiny"].params, t_configs["flux-tiny"].params
SMALL_KW = dict(in_channels=4, vec_in_dim=8, context_in_dim=8, hidden_size=32, mlp_ratio=2.0,
                num_heads=2, axes_dim=(4, 6, 6), qkv_bias=True, guidance_embed=False)


def close(got, want, tol, msg=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    if isinstance(want, torch.Tensor):
        want = want.detach().float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), err_msg=msg, **tol)


def to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def t_mesh(two_devices=False, **shape):
    """A mesh of CPU ranks; with `two_devices`, ranks alternate between the
    device objects cpu:0 and cpu:1, so a replicated piece is two copies
    (what ranks on two cards hold) and the replicas' gradients must be
    summed."""
    n = int(np.prod(list(shape.values())))
    devices = [torch.device("cpu", r % 2) for r in range(n)] if two_devices else [CPU] * n
    return t_make_mesh(**shape, devices=devices)


@pytest.fixture(scope="module")
def flux():
    params = init_flux_params(jax.random.PRNGKey(0), J_CFG, jnp.float32)
    return params, to_torch(params)


def forward_inputs(cfg, b, seed=0, concepts=False):
    keys = jax.random.split(jax.random.PRNGKey(seed), 6)
    out = dict(
        img=jax.random.normal(keys[0], (b, 16, cfg.in_channels)),
        img_ids=make_img_ids(4, 4, b),
        txt=jax.random.normal(keys[1], (b, 4, cfg.context_in_dim)),
        txt_ids=jnp.zeros((b, 4, 3)),
        timesteps=jnp.linspace(0.3, 0.7, b),
        y=jax.random.normal(keys[2], (b, cfg.vec_in_dim)),
    )
    if concepts:
        out.update(concepts=jax.random.normal(keys[3], (b, 3, cfg.context_in_dim)),
                   concept_ids=jnp.zeros((b, 3, 3)),
                   concept_vec=jax.random.normal(keys[4], (b, cfg.vec_in_dim)))
    return out, {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


# -- the mesh and the runner ---------------------------------------------------------------------


def test_make_mesh_takes_all_five_axes():
    mesh = t_mesh(data=2, pipe=1, expert=2, seq=1, model=2)
    jm = j_make_mesh(data=2, expert=2, model=2)
    assert mesh.axis_names == tuple(jm.axis_names)
    assert mesh.shape == dict(jm.shape)
    assert mesh.sub(data=1).shape == {**mesh.shape, "data": 1}
    with pytest.raises(ValueError, match="needs 16 devices"):
        t_make_mesh(data=4, model=4, devices=[CPU] * 8)


def test_collectives_over_shards_and_their_gradients():
    xs = [torch.arange(8.0).reshape(2, 4).requires_grad_(True) + r for r in range(4)]
    total = t_coll.psum(xs)
    assert all(t is total[0] for t in total)  # one device: one tensor
    close(total[0], sum(x.detach() for x in xs), OWN)
    got = t_coll.all_to_all(xs, 1, 0)
    for j in range(4):
        close(got[j], torch.cat([x.detach()[:, j:j + 1] for x in xs]), OWN)
    perm = t_coll.ppermute(xs, [(r, (r + 1) % 4) for r in range(4)])
    close(perm[1], xs[0].detach(), OWN)
    close(t_coll.all_gather(xs, 1)[2], torch.cat([x.detach() for x in xs], 1), OWN)
    # autograd through the copies and sums
    leaves = [torch.randn(3, requires_grad=True) for _ in range(4)]
    (t_coll.psum(leaves)[0] * torch.arange(3.0)).sum().backward()
    for leaf in leaves:
        close(leaf.grad, torch.arange(3.0), OWN)


def test_shard_map_generator_bodies_step_in_lock_step():
    mesh = t_mesh(data=2, model=2)

    def body(rank, x):
        s = yield t_coll.lax.psum(x.sum(), "model")
        m = yield t_coll.lax.pmax(x.max(), "data")
        rows = yield t_coll.lax.all_gather(x, "data", dim=0)  # [4, 2]: this model column
        assert torch.equal(rows, x_full[:, 2 * rank.index("model"):2 * rank.index("model") + 2])
        left = yield t_coll.lax.ppermute(x, "model", [(0, 1)])  # model rank 1 gets rank 0's
        if rank.index("model") == 1:
            assert torch.equal(left, x_full[2 * rank.index("data"):2 * rank.index("data") + 2, :2])
        else:
            assert not left.any()
        return x * 0 + s + m + rank.index("model")

    x = x_full = torch.arange(16.0).reshape(4, 4)
    out = t_coll.shard_map(body, mesh, (t_coll.P("data", "model"),), t_coll.P("data", "model"))(x)
    want = torch.empty(4, 4)
    for d in range(2):
        for m in range(2):
            rows, cols = slice(2 * d, 2 * d + 2), slice(2 * m, 2 * m + 2)
            s = x[rows].sum()
            mx = max(x[2 * e:2 * e + 2, cols].max() for e in range(2))
            want[rows, cols] = s + mx + m
    close(out, want, OWN)


# -- tensor parallelism: placement and the forward -------------------------------------------


def test_param_sharding_placement(flux):
    j_params, t_params = flux
    jm, tm = j_make_mesh(data=2, model=4), t_mesh(data=2, model=4)
    jsh, tsh = j_sharding.shard_params(j_params, jm, J_CFG), t_sharding.shard_params(t_params, tm, T_CFG)
    for path in (("double", "img_qkv", "w"), ("double", "img_mlp_in", "w"), ("single", "proj", "w"),
                 ("single", "mlp_out", "w"), ("double", "img_mod", "w"), ("double", "txt_qkv", "b")):
        jl, tl = jsh, tsh
        for k in path:
            jl, tl = jl[k], tl[k]
        want = tuple(jl.sharding.spec) + (None,) * (jl.ndim - len(jl.sharding.spec))
        assert tl.spec == want, path
        # each rank's piece is the JAX device's shard at the same mesh position
        for coords in np.ndindex(tm.devices.shape):
            jdev = jm.devices[coords]
            shard = next(s for s in jl.addressable_shards if s.device == jdev)
            close(tl.shard(coords), np.asarray(shard.data), dict(rtol=0, atol=0))
    full = t_sharding.gather_tree(tsh)
    for a, b in zip(tree_leaves(full), tree_leaves(t_params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mesh_shape", [dict(data=2, model=4), dict(model=2), dict(data=2)])
def test_sharded_forward_matches_single_device(flux, mesh_shape):
    j_params, t_params = flux
    j_in, t_in = forward_inputs(J_CFG, 2, concepts=True)
    want, want_sal = j_forward(j_params, J_CFG, **j_in)
    jm = j_make_mesh(**mesh_shape)
    j_sharded = jax.jit(lambda p, kw: j_forward(p, J_CFG, **kw))(
        j_sharding.shard_params(j_params, jm, J_CFG), j_in)
    got, got_sal = t_forward(t_sharding.shard_params(t_params, t_mesh(**mesh_shape), T_CFG),
                             T_CFG, **t_in)
    close(got, j_sharded[0], FWD)
    close(got, want, FWD)
    for tap in want_sal:
        close(got_sal[tap], want_sal[tap], FWD, tap)


@pytest.mark.parametrize("mode", ["w8", "w8a8", "w4"])
def test_quantized_params_shard_and_match(flux, mode):
    """JAX's quantized tree (its default min_size) and every stack quantized
    (min_size 0, w4's group scales replicated where their count does not
    divide `model`), sharded over (data=2, model=4) against the dense
    quantized forward of each package."""
    j_params, t_params = flux
    j_in, t_in = forward_inputs(J_CFG, 2, concepts=True)
    jq = j_quant.quantize_flux_params(j_params, mode=mode)
    jm, tm = j_make_mesh(data=2, model=4), t_mesh(data=2, model=4)
    j_sharded = j_sharding.shard_params(jq, jm, J_CFG)
    qk = {"w8": "q", "w8a8": "qa", "w4": "q4p"}[mode]
    tq = t_quant.int8_gemm_layout(to_torch(jq))
    t_sharded = t_sharding.shard_params(tq, tm, T_CFG)
    leaf = t_sharded["double"]["img_qkv"]["w"][qk]
    assert leaf.spec == tuple(j_sharded["double"]["img_qkv"]["w"][qk].sharding.spec)
    want = jax.jit(lambda p: j_forward(p, J_CFG, **j_in)[0])(j_sharded)
    got, _ = t_forward(t_sharded, T_CFG, **t_in)
    close(got, want, FWD)
    every = t_quant.quantize_flux_params(t_params, mode=mode, min_size=0)
    dense, dense_sal = t_forward(every, T_CFG, **t_in)
    got, got_sal = t_forward(t_sharding.shard_params(every, tm, T_CFG), T_CFG, **t_in)
    close(got, dense, OWN)
    for tap in dense_sal:
        close(got_sal[tap], dense_sal[tap], dict(rtol=1e-5, atol=1e-4), tap)


def test_row_parallel_w8a8_quantizes_against_the_whole_row():
    """The per-token scale of a row-parallel w8a8 product is the whole row's
    absmax: the TP product equals the dense one bit for bit, and a rank
    that quantized against its own half would not."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(2, 5, 64, generator=gen)
    x[..., 32:] *= 4.0  # the second rank's half holds the row's absmax
    cell = t_quant.quantize_layer_stack({"w": torch.randn(1, 64, 48, generator=gen)},
                                        min_size=0, mode="w8a8")
    p = {"w": {k: v[0] for k, v in cell["w"].items()}, "b": torch.randn(48, generator=gen)}
    dense = t_blocks._linear(x, p)
    tm = t_mesh(model=2)
    placed = t_sharding.place_tree(p, tm, {"w": t_coll.P("model", None), "b": t_coll.P()}, lead=0)

    def body(rank, pl, xl):
        return (yield from t_blocks._row_linear(xl, pl, "model"))

    got = t_coll.shard_map(body, tm, (None, t_coll.P(None, None, "model")), None)(placed, x)
    assert torch.equal(got, dense)
    halves = [t_blocks._linear(x[..., 32 * r:32 * (r + 1)], {"w": {
        "qa": p["w"]["qa"][32 * r:32 * (r + 1)], "scale": p["w"]["scale"]}}) for r in range(2)]
    assert (halves[0] + halves[1] + p["b"] - dense).abs().max() > 1e-3  # the per-rank scale differs


def test_shard_params_guidance_model_without_cfg():
    cfg = dataclasses.replace(T_CFG, guidance_embed=True)
    params = t_quant.init_flux_params_quantized(torch.Generator().manual_seed(1), cfg, torch.float32,
                                                mode="w8")
    sharded = t_sharding.shard_params(params, t_mesh(data=2, model=4))  # no cfg
    assert "guidance_in" in sharded
    leaf = tree_leaves(sharded["guidance_in"])[0]
    assert leaf.spec == (None,) * leaf.dim()


def small_block_fixture(depth, b=4):
    cfg_j, cfg_t = JFluxConfig(depth=depth, depth_single_blocks=1, **SMALL_KW), TFluxConfig(
        depth=depth, depth_single_blocks=1, **SMALL_KW)
    params = init_flux_params(jax.random.PRNGKey(0), cfg_j, jnp.float32)
    p_tok, t_tok, c_tok = 8, 4, 3
    keys = jax.random.split(jax.random.PRNGKey(6), 5)
    ids = jnp.tile(jnp.arange(t_tok + p_tok, dtype=jnp.float32)[None, :, None], (b, 1, 3))
    cids = jnp.tile(jnp.arange(c_tok + p_tok, dtype=jnp.float32)[None, :, None], (b, 1, 3))
    carry = {
        "img": jax.random.normal(keys[0], (b, p_tok, cfg_j.hidden_size)),
        "txt": jax.random.normal(keys[1], (b, t_tok, cfg_j.hidden_size)),
        "con": jax.random.normal(keys[2], (b, c_tok, cfg_j.hidden_size)),
        "vec": jax.random.normal(keys[3], (b, cfg_j.hidden_size)),
        "cvec": jax.random.normal(keys[4], (b, cfg_j.hidden_size)),
        "pe": j_embed_nd(ids, cfg_j.axes_dim, cfg_j.theta),
        "cpe": j_embed_nd(cids, cfg_j.axes_dim, cfg_j.theta),
    }
    t_carry = tree_map(torch.from_numpy, jax.tree.map(np.array, carry))
    return cfg_j, cfg_t, params, carry, t_carry


def j_double_layer(cfg, tp_axis=None):
    def layer(lp, c):
        img, txt, con, sal = j_blocks.double_block(
            lp, c["img"], c["txt"], c["vec"], c["pe"], cfg.num_heads, concepts=c["con"],
            concept_vec=c["cvec"], concept_pe=c["cpe"], spec=JSpec(), tp_axis=tp_axis)
        return {**c, "img": img, "txt": txt, "con": con}, sal
    return layer


def t_double_layer(cfg, tp_axis=None, spec=TSpec(backend="sdpa")):
    def layer(lp, c):
        img, txt, con, sal = t_blocks.double_block(
            lp, c["img"], c["txt"], c["vec"], c["pe"], cfg.num_heads, concepts=c["con"],
            concept_vec=c["cvec"], concept_pe=c["cpe"], spec=spec, tp_axis=tp_axis)
        return {**c, "img": img, "txt": txt, "con": con}, sal
    return layer


@pytest.mark.parametrize("backend", ["sdpa", "fused"])
def test_tp_block_matches_dense(backend):
    """double_block(tp_axis="model") on Megatron-sharded weights against the
    JAX tensor-parallel block under shard_map and the dense block."""
    cfg_j, cfg_t, params, c, tc = small_block_fixture(depth=1)
    lp = jax.tree.map(lambda a: a[0], params["double"])
    jm = j_make_mesh(model=2)
    in_spec = j_sharding.double_block_layer_spec()
    out_spec = ({"img": JP(), "txt": JP(), "con": JP(), "vec": JP(), "cvec": JP(), "pe": JP(),
                 "cpe": JP()}, {"output": JP(), "cross_attention": JP()})
    want_c, want_sal = jax.jit(shard_map_compat(
        lambda p: j_double_layer(cfg_j, "model")(p, c), jm, (in_spec,), out_spec))(lp)
    tlp = t_sharding.place_tree(to_torch(lp), t_mesh(model=2), t_sharding.double_block_layer_spec(),
                                lead=0)
    got_c, got_sal = t_double_layer(cfg_t, "model", TSpec(backend=backend))(tlp, tc)
    dense_c, dense_sal = t_double_layer(cfg_t, None, TSpec(backend=backend))(to_torch(lp), tc)
    for k in ("img", "txt", "con"):
        close(got_c[k], want_c[k], BLOCK, k)
        close(got_c[k], dense_c[k], OWN, k)
    for k in want_sal:
        close(got_sal[k], want_sal[k], BLOCK, k)
        close(got_sal[k], dense_sal[k], OWN, k)


def test_tp_single_block_matches_dense():
    cfg_j, cfg_t, params, c, tc = small_block_fixture(depth=1)
    lp = jax.tree.map(lambda a: a[0], params["single"])
    x = jnp.concatenate([c["txt"], c["img"]], axis=1)
    hidden = int(cfg_j.hidden_size * cfg_j.mlp_ratio)
    want = j_blocks.single_block(lp, x, c["vec"], c["pe"], cfg_j.num_heads, hidden)
    from conceptattention_torch.parallel.sharding import _single_block_spec

    tlp = t_sharding.place_tree(to_torch(lp), t_mesh(model=2), _single_block_spec(), lead=0)
    for backend in ("sdpa", "fused"):
        got = t_blocks.single_block(tlp, torch.from_numpy(np.array(x)), tc["vec"], tc["pe"],
                                    cfg_t.num_heads, hidden, backend=backend, tp_axis="model")
        close(got, want, BLOCK, backend)


@pytest.mark.parametrize("case", ["raw vectors", "heads", "no layout"])
def test_tp_refusals(case):
    cfg_j, cfg_t, params, c, tc = small_block_fixture(depth=1)
    lp = to_torch(jax.tree.map(lambda a: a[0], params["double"]))
    spec = TSpec(backend="sdpa", return_raw_vectors=(case == "raw vectors"))
    if case == "raw vectors":
        placed = t_sharding.place_tree(lp, t_mesh(model=2), t_sharding.double_block_layer_spec(), lead=0)
        with pytest.raises(ValueError, match="return_raw_vectors"):
            t_double_layer(cfg_t, "model", spec)(placed, tc)
    elif case == "heads":  # 2 heads over 4 ranks: the head axis does not split
        with pytest.raises(ValueError, match="divisible|divide"):
            placed = t_sharding.place_tree(lp, t_mesh(model=4), t_sharding.double_block_layer_spec(),
                                           lead=0)
            t_double_layer(cfg_t, "model", spec)(placed, tc)
    else:
        with pytest.raises(ValueError, match="laid out over a mesh"):
            t_double_layer(cfg_t, "model", spec)(lp, tc)


# -- FSDP -------------------------------------------------------------------------------------


FSDP_B = 8


@pytest.fixture(scope="module")
def fsdp_batch():
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    batch = dict(
        img=jax.random.normal(keys[0], (FSDP_B, 16, J_CFG.in_channels)),
        img_ids=make_img_ids(4, 4, FSDP_B),
        txt=jax.random.normal(keys[1], (FSDP_B, 4, J_CFG.context_in_dim)),
        txt_ids=jnp.zeros((FSDP_B, 4, 3)),
        y=jax.random.normal(keys[2], (FSDP_B, J_CFG.vec_in_dim)),
    )
    return batch, {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def spec_tree_equal(t_tree, j_tree, t_params):
    flat_j = jax.tree.leaves(j_tree, is_leaf=lambda x: isinstance(x, JP))
    flat_t = [s for s in _spec_leaves(t_tree)]
    shapes = [x.shape for x in tree_leaves(t_params)]
    assert len(flat_j) == len(flat_t) == len(shapes)
    for j, t, shape in zip(flat_j, flat_t, shapes):
        assert tuple(j) + (None,) * (len(shape) - len(j)) == tuple(t) + (None,) * (len(shape) - len(t))


def _spec_leaves(tree):
    if isinstance(tree, t_coll.P):
        return [tree]
    return [s for v in tree.values() for s in _spec_leaves(v)]


@pytest.mark.parametrize("mesh_shape,tp", [(dict(data=4), False), (dict(data=4, model=2), True)])
def test_fsdp_spec_matches_jax(flux, mesh_shape, tp):
    """The leaf choice: the largest dimension `data` divides that TP leaves
    free, as JAX picks it, with and without the TP base spec, and with
    min_size."""
    j_params, t_params = flux
    jm, tm = j_make_mesh(**mesh_shape), t_mesh(**mesh_shape)
    j_base = j_sharding.flux_param_spec(J_CFG) if tp else None
    t_base = t_sharding.flux_param_spec(T_CFG) if tp else None
    for min_size in (0, 4096):
        spec_tree_equal(t_fsdp.fsdp_spec(t_params, tm, base_spec=t_base, min_size=min_size),
                        j_fsdp.fsdp_spec(j_params, jm, base_spec=j_base, min_size=min_size),
                        t_params)


def test_fsdp_reduces_per_device_bytes_and_refuses_quantized_trees(flux):
    _, t_params = flux
    mesh = t_mesh(data=4)
    placed = t_fsdp.shard_params_fsdp(t_params, mesh, T_CFG)
    total = sum(x.numel() * x.element_size() for x in tree_leaves(t_params))
    per_rank = t_sharding.bytes_per_rank(placed, (0,) * 5)
    assert per_rank < 0.3 * total
    assert torch.equal(t_sharding.gather_tree(placed)["double"]["img_mlp_in"]["w"],
                       t_params["double"]["img_mlp_in"]["w"])
    with pytest.raises(ValueError, match="LoRA"):
        t_fsdp.shard_params_fsdp(t_quant.quantize_flux_params(t_params), mesh, T_CFG)


def jax_draws(key, x_shape):
    t_key, eps_key = jax.random.split(key)
    t = jax.nn.sigmoid(jax.random.normal(t_key, (x_shape[0],)))
    eps = jax.random.normal(eps_key, x_shape, jnp.float32)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(eps))


@pytest.mark.parametrize("mesh_shape", [dict(data=8), dict(data=4, model=2),
                                        dict(data=4, model=2, two_devices=True)])
def test_fsdp_train_step_matches_unsharded(flux, fsdp_batch, mesh_shape):
    """One AdamW step of the FSDP (x TP) layout against the port's
    one-device step and the JAX package's unsharded step on the same batch
    and draws: the loss, and the updated parameters gathered; AdamW's
    moments live in the layout. As in `tests/test_torch_training.py`,
    elements whose first gradient is below 1e-6 are left out (Adam's g /
    (sqrt(v) + eps) turns rounding of the sums there, taken in another
    order by the batch split or by the other package, into step
    differences of up to 1e-4; at most 1% of the elements)."""
    from conceptattention_torch.training import flow_matching_loss as t_loss

    j_params, t_params = flux
    j_batch, t_batch = fsdp_batch
    key = jax.random.PRNGKey(42)
    tx, opt0 = j_init_state(j_params, learning_rate=1e-3)
    ref_params, _, ref_loss = j_make_step(J_CFG, tx, donate=False)(j_params, opt0, j_batch, key)
    t, eps = jax_draws(key, j_batch["img"].shape)

    dense = tree_map(lambda x: x.clone(), t_params)
    dense_loss = t_make_step(T_CFG, t_init_state(dense, learning_rate=1e-3))(dense, t_batch, t=t,
                                                                              eps=eps)
    probe = tree_map(lambda x: x.clone().requires_grad_(True), t_params)
    t_loss(probe, T_CFG, t_batch, t=t, eps=eps).backward()

    mesh = t_mesh(**mesh_shape)
    placed = t_fsdp.shard_params_fsdp(t_params, mesh, T_CFG)
    shardings = t_fsdp.flux_fsdp_sharding(t_params, mesh, T_CFG)
    opt = t_init_state(placed, learning_rate=1e-3)
    assert bool(t_sharding.replica_groups(placed)) == mesh_shape.get("two_devices", False)
    step = t_make_step(T_CFG, opt, mesh=mesh, param_sharding=shardings,
                       batch_sharding=t_coll.NamedSharding(mesh, t_coll.P("data")))
    loss = step(placed, t_batch, t=t, eps=eps)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(dense_loss), rtol=1e-6)
    w = placed["double"]["img_mlp_out"]["w"]
    assert "data" in w.spec
    piece = w.shard((0,) * 5)
    assert opt.state[piece]["exp_avg"].shape == piece.shape  # the moments are sharded too
    got = t_sharding.gather_tree(placed)
    for path in (("double", "img_mlp_out", "w"), ("single", "qkv", "w"), ("final", "linear", "w")):
        g, r, d, gr = got, ref_params, dense, probe
        for k in path:
            g, r, d, gr = g[k], r[k], d[k], gr[k]
        keep = gr.grad.abs().numpy() >= 1e-6
        assert (~keep).sum() <= 0.01 * keep.size
        np.testing.assert_allclose(g.detach().numpy()[keep], d.detach().numpy()[keep], atol=1e-6,
                                   rtol=1e-5, err_msg=f"{path} against the one-device step")
        np.testing.assert_allclose(g.detach().numpy()[keep], np.asarray(r)[keep], atol=1e-4,
                                   rtol=1e-4, err_msg=str(path))


@pytest.mark.parametrize("before", ["no_grad", "inference_mode", "grad before init"])
def test_fsdp_train_step_after_an_earlier_forward(flux, fsdp_batch, before):
    """A forward over the placed tree before `init_train_state` (an eval
    loss under no_grad or inference_mode, or with grad on before the
    pieces require it) leaves the step's gradients whole: every stacked
    leaf moves as in the one-device step."""
    from conceptattention_torch.training import flow_matching_loss as t_loss

    _, t_params = flux
    _, t_batch = fsdp_batch
    t, eps = jax_draws(jax.random.PRNGKey(3), t_batch["img"].shape)
    dense = tree_map(lambda x: x.clone(), t_params)
    t_make_step(T_CFG, t_init_state(dense, learning_rate=1e-3))(dense, t_batch, t=t, eps=eps)

    mesh = t_mesh(data=4, model=2)
    placed = t_fsdp.shard_params_fsdp(t_params, mesh, T_CFG)
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode,
           "grad before init": torch.enable_grad}[before]
    with ctx():
        t_loss(placed, T_CFG, t_batch, t=t, eps=eps)
    step = t_make_step(T_CFG, t_init_state(placed, learning_rate=1e-3), mesh=mesh,
                       param_sharding=t_fsdp.flux_fsdp_sharding(t_params, mesh, T_CFG),
                       batch_sharding=t_coll.NamedSharding(mesh, t_coll.P("data")))
    step(placed, t_batch, t=t, eps=eps)
    got = t_sharding.gather_tree(placed)
    def paths(tree, pre=()):
        if isinstance(tree, dict):
            return [q for k, v in tree.items() for q in paths(v, pre + (k,))]
        return [pre]

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    for stack in ("double", "single"):
        for path in paths(dense[stack], (stack,)):
            g, d, p0 = at(got, path), at(dense, path), at(t_params, path)
            assert not torch.equal(g, p0), f"{path} did not move"
            np.testing.assert_allclose(g.detach().numpy(), d.detach().numpy(), atol=1e-4, rtol=1e-4,
                                       err_msg=str(path))


def test_fsdp_loss_only_matches(flux, fsdp_batch):
    from conceptattention_torch.training import flow_matching_loss as t_loss
    from conceptattention_tpu.training.train_step import flow_matching_loss as j_loss

    j_params, t_params = flux
    j_batch, t_batch = fsdp_batch
    key = jax.random.PRNGKey(7)
    dense = float(jax.jit(j_loss, static_argnames="cfg")(j_params, J_CFG, j_batch, key))
    t, eps = jax_draws(key, j_batch["img"].shape)
    placed = t_fsdp.shard_params_fsdp(t_params, t_mesh(data=8), T_CFG)
    np.testing.assert_allclose(float(t_loss(placed, T_CFG, t_batch, t=t, eps=eps)), dense, rtol=1e-6)


@pytest.mark.parametrize("two_devices", [False, True])
def test_fsdp_x_tp_train_loop_matches_one_device(flux, fsdp_batch, two_devices):
    """`train_loop` over (data=2, model=2): losses, gradient norms,
    parameters and EMA equal the one-device loop's; the state keeps the
    layout (with ranks on two devices, the replicated pieces' copies take
    the summed gradient, and the norm counts each piece once)."""
    _, t_params = flux
    _, t_batch = fsdp_batch

    def stream():
        while True:
            yield t_batch

    tc = TTrainConfig(total_steps=3, grad_accum=1, warmup_steps=1, log_every=100)
    one = t_train_loop(t_params, T_CFG, stream(), tc, log=lambda s: None)
    mesh = t_mesh(data=2, model=2, two_devices=two_devices)
    placed = t_fsdp.shard_params_fsdp(t_params, mesh, T_CFG)
    run = t_train_loop(placed, T_CFG, stream(), tc, mesh=mesh, log=lambda s: None)
    np.testing.assert_allclose(run["losses"], one["losses"], rtol=1e-5)
    np.testing.assert_allclose(run["grad_norms"], one["grad_norms"], rtol=1e-4)
    for name in ("params", "ema"):
        got = t_sharding.gather_tree(run[name])
        for a, b in zip(tree_leaves(got), tree_leaves(one[name])):
            close(a, b, dict(atol=1e-5, rtol=1e-4), name)


# -- GPipe -----------------------------------------------------------------------------------


def mlp_stack(seed, depth, d, hidden):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return {"w1": jax.random.normal(k1, (depth, d, hidden)) / d**0.5,
            "w2": jax.random.normal(k2, (depth, hidden, d)) / hidden**0.5}


def j_mlp_layer(p, x):
    return x + jnp.tanh(x @ p["w1"]) @ p["w2"]


def t_mlp_layer(p, x):
    return x + torch.tanh(x @ p["w1"]) @ p["w2"]


@pytest.mark.parametrize("stages,micro", [(4, 4), (2, 8), (4, 8)])
def test_pipeline_matches_scan(stages, micro):
    params = mlp_stack(0, 8, 16, 32)
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 6, 16))
    jm = j_make_mesh(pipe=stages, model=8 // stages)
    want = jax.jit(lambda p, x: j_pipeline_apply(j_mlp_layer, p, x, jm, num_microbatches=micro))(
        params, x)
    stack = stacked_params_from_numpy(jax.tree.map(np.asarray, params))
    got = t_pipeline_apply(t_mlp_layer, stack, torch.from_numpy(np.array(x)),
                           t_mesh(pipe=stages, model=8 // stages), num_microbatches=micro)
    close(got, want, MLP)


def test_pipeline_gradients_match_scan():
    params = mlp_stack(2, 4, 8, 16)
    x = jax.random.normal(jax.random.PRNGKey(3), (4, 3, 8))

    def loss_scan(p):
        y, _ = jax.lax.scan(lambda c, lp: (j_mlp_layer(lp, c), None), x, p)
        return jnp.sum(y**2)

    want = jax.grad(loss_scan)(params)
    tp = tree_map(lambda a: a.requires_grad_(True), to_torch(params))
    y = t_pipeline_apply(t_mlp_layer, tp, torch.from_numpy(np.array(x)), t_mesh(pipe=4, model=2),
                         num_microbatches=4)
    (y**2).sum().backward()
    for k in want:
        close(tp[k].grad, want[k], dict(rtol=1e-4, atol=1e-5), k)


def test_pipeline_rejects_bad_divisibility():
    mesh = t_mesh(pipe=4, model=2)
    params = to_torch(mlp_stack(0, 6, 8, 16))  # 6 % 4 != 0
    with pytest.raises(ValueError, match="not divisible"):
        t_pipeline_apply(t_mlp_layer, params, torch.zeros(4, 2, 8), mesh, num_microbatches=4)
    with pytest.raises(ValueError, match="not divisible"):
        t_pipeline_apply(t_mlp_layer, to_torch(mlp_stack(0, 4, 8, 16)), torch.zeros(6, 2, 8), mesh,
                         num_microbatches=4)


def test_pipeline_ys_and_scalar_aux_leaf():
    """Batch-leading ys come back [depth, batch, ...] as the scan's; a
    per-layer scalar comes back [depth, m], one value per microbatch."""
    depth = 4
    params = mlp_stack(6, depth, 8, 16)
    x = jax.random.normal(jax.random.PRNGKey(7), (8, 4, 8))

    def j_layer(p, c):
        out = j_mlp_layer(p, c)
        return out, {"tap": jnp.mean(out, axis=1), "norm": jnp.mean(out**2)}

    def t_layer(p, c):
        out = t_mlp_layer(p, c)
        return out, {"tap": out.mean(1), "norm": (out**2).mean()}

    want_c, want_ys = jax.lax.scan(lambda c, lp: j_layer(lp, c), x, params)
    jm = j_make_mesh(pipe=4, model=2)
    j_c, j_ys = jax.jit(lambda p, x: j_pipeline_apply(j_layer, p, x, jm, num_microbatches=4,
                                                      with_outputs=True))(params, x)
    got_c, got_ys = t_pipeline_apply(t_layer, to_torch(params), torch.from_numpy(np.array(x)),
                                     t_mesh(pipe=4, model=2), num_microbatches=4, with_outputs=True)
    close(got_c, want_c, MLP)
    close(got_ys["tap"], want_ys["tap"], MLP)
    assert got_ys["norm"].shape == j_ys["norm"].shape == (depth, 4)
    close(got_ys["norm"], j_ys["norm"], MLP)


@pytest.mark.parametrize("composition", ["pp", "pp x tp", "pp x dp x tp"])
def test_pipelined_double_blocks_with_saliency(composition):
    """Flux double blocks with concept taps pipelined (4 stages, or 2 with
    dp), optionally tensor-parallel per stage and data-parallel: the carry
    and the [depth, B, C, P] saliency stack against the JAX package's
    pipeline and scan."""
    depth = 2 if composition == "pp x dp x tp" else 4
    cfg_j, cfg_t, params, carry, t_carry = small_block_fixture(depth)
    stack = params["double"]
    want_c, want_sal = jax.lax.scan(lambda c, lp: j_double_layer(cfg_j)(lp, c), carry, stack)
    kw = dict(num_microbatches=4, with_outputs=True)
    if composition == "pp":
        mesh_shape = dict(pipe=4, model=2)
        j_layer, t_layer = j_double_layer(cfg_j), t_double_layer(cfg_t)
    else:
        mesh_shape = dict(pipe=4, model=2) if composition == "pp x tp" else dict(pipe=2, data=2, model=2)
        j_layer, t_layer = j_double_layer(cfg_j, "model"), t_double_layer(cfg_t, "model")
        kw.update(layer_param_spec=j_sharding.double_block_layer_spec())
        if composition == "pp x dp x tp":
            kw.update(num_microbatches=2, batch_axis="data")
    jm = j_make_mesh(**mesh_shape)
    j_c, j_sal = jax.jit(lambda p, c: j_pipeline_apply(
        j_layer, p, c, jm, shape_probe_fn=j_double_layer(cfg_j), **kw))(stack, carry)
    t_kw = dict(kw)
    if "layer_param_spec" in t_kw:
        t_kw["layer_param_spec"] = t_sharding.double_block_layer_spec()
    got_c, got_sal = t_pipeline_apply(t_layer, to_torch(stack), t_carry, t_mesh(**mesh_shape), **t_kw)
    for k in ("img", "txt", "con"):
        close(got_c[k], want_c[k], BLOCK, k)
        close(got_c[k], j_c[k], BLOCK, k)
    for k in want_sal:
        assert got_sal[k].shape == want_sal[k].shape
        close(got_sal[k], want_sal[k], BLOCK, k)


def test_pipelined_flux_single_blocks():
    cfg_j, cfg_t, params, carry, t_carry = small_block_fixture(depth=1)
    cfg_j = dataclasses.replace(cfg_j, depth_single_blocks=4)
    params = init_flux_params(jax.random.PRNGKey(0), cfg_j, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, cfg_j.hidden_size))
    vec = jax.random.normal(jax.random.PRNGKey(2), (4, cfg_j.hidden_size))
    ids = jnp.tile(jnp.arange(8, dtype=jnp.float32)[None, :, None], (4, 1, 3))
    pe = j_embed_nd(ids, cfg_j.axes_dim, cfg_j.theta)
    hidden = int(cfg_j.hidden_size * cfg_j.mlp_ratio)

    def j_layer(lp, c):
        return {"x": j_blocks.single_block(lp, c["x"], c["vec"], jax.tree.map(
            lambda a: a[:c["x"].shape[0]], pe), cfg_j.num_heads, hidden), "vec": c["vec"]}

    want, _ = jax.lax.scan(lambda c, lp: (j_layer(lp, c), None), {"x": x, "vec": vec}, params["single"])
    t_pe = tuple(torch.from_numpy(np.array(a)) for a in pe)

    def t_layer(lp, c):
        return {"x": t_blocks.single_block(lp, c["x"], c["vec"], tuple(a[:c["x"].shape[0]] for a in t_pe),
                                           cfg_t.num_heads, hidden), "vec": c["vec"]}

    got = t_pipeline_apply(t_layer, to_torch(params["single"]),
                           {"x": torch.from_numpy(np.array(x)), "vec": torch.from_numpy(np.array(vec))},
                           t_mesh(pipe=4, model=2), num_microbatches=4)
    close(got["x"], want["x"], BLOCK)


# -- MoE -------------------------------------------------------------------------------------


def moe_pair(seed, d, hidden, e):
    j = j_moe.init_moe_params(jax.random.PRNGKey(seed), d, hidden, e)
    return j, moe_params_from_numpy(jax.tree.map(np.asarray, j))


def test_moe_dense_matches_jax_and_drops():
    jp, tp = moe_pair(0, 16, 32, 8)
    x = jax.random.normal(jax.random.PRNGKey(1), (32, 16))
    tx = torch.from_numpy(np.array(x))
    for top_k, cap in ((2, 32), (1, 32), (2, 3), (2, None)):
        want, want_aux = j_moe.moe_mlp(jp, x, top_k=top_k, capacity=cap)
        got, aux = t_moe.moe_mlp(tp, tx, top_k=top_k, capacity=cap)
        close(got, want, MLP, f"top_k={top_k} capacity={cap}")
        np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    out, _ = t_moe.moe_mlp(tp, tx, top_k=2, capacity=0)
    assert torch.equal(out, torch.zeros_like(out))  # capacity 0 keeps nothing
    t_init = t_moe.init_moe_params(torch.Generator().manual_seed(0), 16, 32, 8)
    assert {k: tuple(v.shape) for k, v in t_init.items()} == {k: v.shape for k, v in jp.items()}


@pytest.mark.parametrize("top_k,capacity", [(1, None), (2, None), (2, 3)])
def test_moe_expert_parallel_matches(top_k, capacity):
    """The all-to-all dispatch over expert=4 against JAX's expert-parallel
    MoE on the same mesh shape, and, without drops (capacity top_k * n /
    ep), against the dense reference; (2, 3) drops tokens."""
    d, e, n, ep = 16, 8, 32, 4
    jp, tp = moe_pair(6, d, 32, e)
    x = jax.random.normal(jax.random.PRNGKey(7), (n, d))
    tx = torch.from_numpy(np.array(x))
    cap = top_k * n // ep if capacity is None else capacity
    jm = j_make_mesh(expert=ep, model=2)
    want, want_aux = jax.jit(lambda p, x: j_moe.moe_mlp_expert_parallel(
        p, x, jm, top_k=top_k, capacity=cap))(jp, x)
    got, aux = t_moe.moe_mlp_expert_parallel(tp, tx, t_mesh(expert=ep, model=2), top_k=top_k,
                                             capacity=cap)
    close(got, want, MLP)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)
    if capacity is None:
        dense, dense_aux = t_moe.moe_mlp(tp, tx, top_k=top_k, capacity=n)
        close(got, dense, MLP)
        np.testing.assert_allclose(float(aux), float(dense_aux), rtol=1e-5)


def test_moe_expert_parallel_gradients_and_refusals():
    d, e, n, ep = 8, 4, 16, 4
    _, tp = moe_pair(8, d, 16, e)
    tp = tree_map(lambda a: a.requires_grad_(True), tp)
    x = torch.randn(n, d, generator=torch.Generator().manual_seed(9))
    out, aux = t_moe.moe_mlp_expert_parallel(tp, x, t_mesh(expert=ep), top_k=2, capacity=2 * n // ep)
    ((out**2).sum() + 0.01 * aux).backward()
    assert all(torch.isfinite(v.grad).all() for v in tp.values())
    assert tp["w_in"].grad.abs().sum() > 0 and tp["router"].grad.abs().sum() > 0
    with pytest.raises(ValueError, match="experts not divisible"):
        t_moe.moe_mlp_expert_parallel(moe_pair(0, 8, 16, 6)[1], torch.zeros(8, 8), t_mesh(expert=4))


# -- the dp x sp x tp ring ------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["ring", "ring_rdma"])
def test_dp_sp_tp_composed_flux_forward(backend):
    """flux_forward in ONE (data=2, seq=2, model=2) mesh: Megatron-sharded
    parameters, the batch over data, per-(data, model) seq rings on the
    ranks' heads, against JAX's composed forward (its `ring` backend) and
    the dense one."""
    cfg_j = JFluxConfig(depth=2, depth_single_blocks=1, **SMALL_KW)
    cfg_t = TFluxConfig(depth=2, depth_single_blocks=1, **SMALL_KW)
    params = init_flux_params(jax.random.PRNGKey(0), cfg_j, jnp.float32)
    j_in, t_in = forward_inputs(cfg_j, 2, seed=1, concepts=True)
    ref, ref_sal = j_forward(params, cfg_j, spec=JSpec(), **j_in)
    jm = j_make_mesh(data=2, seq=2, model=2)
    spec3d = JSpec(backend="ring", mesh=jm, seq_axis="seq", batch_axis="data", head_axis="model")
    batch_sh = JNamedSharding(jm, JP("data"))
    sharded_in = {k: (jax.device_put(v, batch_sh) if v.ndim and v.shape[0] == 2 else v)
                  for k, v in j_in.items()}
    want, want_sal = jax.jit(lambda p, kw: j_forward(p, cfg_j, spec=spec3d, **kw))(
        j_sharding.shard_params(params, jm, cfg_j), sharded_in)
    tm = t_mesh(data=2, seq=2, model=2)
    t_spec = TSpec(backend=backend, mesh=tm, seq_axis="seq", batch_axis="data", head_axis="model")
    t_params = to_torch(params)
    for p in (t_sharding.shard_params(t_params, tm, cfg_t), t_params):
        got, got_sal = t_forward(p, cfg_t, spec=t_spec, **t_in)
        close(got, want, COMPOSED)
        close(got, ref, COMPOSED)
        for tap in ref_sal:
            close(got_sal[tap], want_sal[tap], COMPOSED, tap)
            close(got_sal[tap], ref_sal[tap], COMPOSED, tap)


# -- the pipeline on a mesh ------------------------------------------------------------------------


PIPE_KW = dict(width=64, height=64, num_inference_steps=2, return_pil_heatmaps=False,
               return_image_array=True)


@pytest.fixture(scope="module")
def one_device_pipe():
    return TorchPipeline("flux-tiny", dtype=torch.float32, device="cpu")


@pytest.mark.parametrize("mesh_shape", [dict(model=2), dict(data=2, model=2),
                                        dict(seq=2, model=2)])
def test_pipeline_with_a_mesh_matches_one_device(one_device_pipe, mesh_shape):
    """generate_images (batch 2) and encode_image over a TP / DP / ring mesh
    equal the one-device pipeline's; the parameters are laid out at
    construction and again by swap_loras."""
    backend = "ring_rdma" if "seq" in mesh_shape else "fused"
    pipe = TorchPipeline("flux-tiny", dtype=torch.float32, mesh=t_mesh(**mesh_shape),
                         attention_backend=backend, keep_base_for_swap=True)
    assert isinstance(pipe.params["double"]["img_qkv"]["w"], t_coll.Sharded)
    ref = one_device_pipe
    prompts = ["a dragon on a rock", "a castle"]
    got = pipe.generate_images(prompts, ["dragon", "rock"], seeds=[0, 1], **PIPE_KW)
    want = ref.generate_images(prompts, ["dragon", "rock"], seeds=[0, 1], **PIPE_KW)
    for g, w in zip(got, want):
        close(g.concept_heatmaps, w.concept_heatmaps, dict(rtol=1e-4, atol=1e-5))
        assert np.abs(g.image.astype(int) - w.image.astype(int)).max() <= 1
    image = np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    enc = pipe.encode_image(image, ["dragon", "rock"], width=64, height=64, return_pil_heatmaps=False)
    enc_ref = ref.encode_image(image, ["dragon", "rock"], width=64, height=64,
                               return_pil_heatmaps=False)
    close(enc.concept_heatmaps, enc_ref.concept_heatmaps, dict(rtol=1e-4, atol=1e-5))
    pipe.swap_loras(None)
    assert isinstance(pipe.params["double"]["img_qkv"]["w"], t_coll.Sharded)


def test_default_mesh_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_make_mesh(model=2)
