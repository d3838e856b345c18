"""The port's training loop (`training/train_loop.py`) and checkpoints
(`utils/checkpoint.py`) against the JAX package's loop and optax.

The TINY config and data stream are `tests/test_train_loop.py`'s; the JAX
loop's per-step draws (fold_in(PRNGKey(0), i), split into t and eps as
`flow_matching_loss` splits it) are made in the test and passed to the
port's loss, so both loops see the same batches and noise. Tolerances: the
schedule to 1e-7 relative of optax's value at every count (the port
evaluates it in f32 in optax's order with the C library's cosf, as XLA's CPU
backend does); the loop's losses to 1e-5 relative and its parameters and EMA
to 1e-6 absolute (f32 on the CPU); resume bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conceptattention_torch.config import FluxConfig as TFluxConfig
from conceptattention_torch.models.flux.params import init_flux_params as t_init
from conceptattention_torch.models.flux.params import tree_leaves
from conceptattention_torch.ops.packing import make_img_ids as t_img_ids
from conceptattention_torch.training import flow_matching_loss as t_loss
from conceptattention_torch.training import train_loop as t_loop
from conceptattention_torch.training.train_loop import (
    TrainConfig as TTrainConfig,
    latest_checkpoint,
    make_loop_step,
    make_lr_schedule,
    make_optimizer,
    step_seed,
)
from conceptattention_torch.utils.checkpoint import load_params, save_params
from conceptattention_torch.weights.from_jax import params_from_numpy
from conceptattention_tpu.config import FluxConfig as JFluxConfig
from conceptattention_tpu.models.flux.params import init_flux_params
from conceptattention_tpu.ops.packing import make_img_ids
from conceptattention_tpu.training.train_loop import TrainConfig as JTrainConfig
from conceptattention_tpu.training.train_loop import train_loop as j_loop

torch.set_num_threads(2)  # six test workers share the host's cores

TINY_KW = dict(in_channels=4, vec_in_dim=8, context_in_dim=8, hidden_size=32, mlp_ratio=2.0,
               num_heads=2, depth=2, depth_single_blocks=1, axes_dim=(4, 6, 6), qkv_bias=True,
               guidance_embed=False)
J_TINY, T_TINY = JFluxConfig(**TINY_KW), TFluxConfig(**TINY_KW)
B, P_TOK, T_TOK = 2, 16, 4


def jax_stream(seed=0):
    """`tests/test_train_loop.py`'s data stream."""
    base = jax.random.PRNGKey(seed)
    i = 0
    while True:
        ks = jax.random.split(jax.random.fold_in(base, i), 3)
        yield {
            "img": jax.random.normal(ks[0], (B, P_TOK, J_TINY.in_channels)),
            "img_ids": make_img_ids(4, 4, B),
            "txt": jax.random.normal(ks[1], (B, T_TOK, J_TINY.context_in_dim)),
            "txt_ids": jnp.zeros((B, T_TOK, 3)),
            "y": jax.random.normal(ks[2], (B, J_TINY.vec_in_dim)),
        }
        i += 1


def port_stream(seed=0):
    """The same stream's shapes for the port alone, drawn with numpy."""
    i = 0
    while True:
        rng = np.random.default_rng([seed, i])
        yield {
            "img": torch.from_numpy(rng.standard_normal((B, P_TOK, 4), np.float32)),
            "img_ids": t_img_ids(4, 4, B),
            "txt": torch.from_numpy(rng.standard_normal((B, T_TOK, 8), np.float32)),
            "txt_ids": torch.zeros(B, T_TOK, 3),
            "y": torch.from_numpy(rng.standard_normal((B, 8), np.float32)),
        }
        i += 1


def to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree))


def port_params(seed=0):
    return t_init(torch.Generator().manual_seed(seed), T_TINY, torch.float32)


def flat(tensors):
    return np.concatenate([np.asarray(t, np.float64).ravel() for t in tensors])


@pytest.mark.parametrize("warmup,total,accum", [(100, 1000, 1), (0, 10, 1), (8, 40, 4)])
def test_lr_schedule_matches_optax(warmup, total, accum):
    """At every optimizer-update count, the port's schedule is optax's
    (built as the JAX package builds it, in update units)."""
    j_tc = JTrainConfig(total_steps=total, warmup_steps=warmup, grad_accum=accum)
    t_tc = TTrainConfig(total_steps=total, warmup_steps=warmup, grad_accum=accum)
    from conceptattention_tpu.training.train_loop import make_lr_schedule as j_sched

    want_fn, got_fn = j_sched(j_tc), make_lr_schedule(t_tc)
    updates = max(total // accum, warmup // accum + 1)
    for count in range(updates + 3):
        want = float(want_fn(jnp.int32(count)))
        got = got_fn(count)
        assert abs(got - want) <= 1e-7 * abs(want), (count, got, want)
    assert got_fn(0) == (0.0 if warmup // accum else float(np.float32(t_tc.learning_rate)))


def test_lr_schedule_shape_and_units():
    """The JAX tests' properties: 0 at the start, the peak after warmup, the
    floor at the end, in update units under accumulation."""
    sched = make_lr_schedule(TTrainConfig(total_steps=100, learning_rate=1e-3, warmup_steps=10))
    assert sched(0) == 0.0
    assert abs(sched(10) - 1e-3) < 1e-9
    assert sched(100) <= 1e-4 + 1e-9
    assert sched(50) < sched(10)
    tc = TTrainConfig(total_steps=1000, learning_rate=1e-3, warmup_steps=100, grad_accum=4)
    sched = make_lr_schedule(tc)
    assert abs(sched(25) - 1e-3) < 1e-9
    assert sched(250) <= 1e-4 + 1e-9


LOOP = dict(total_steps=6, learning_rate=1e-3, warmup_steps=2, grad_accum=2, ema_decay=0.9,
            max_grad_norm=0.5, log_every=100)


def jax_loop_draws(steps):
    """A port loss that takes, call by call, the t and eps the JAX loop
    draws at steps 0, 1, ... (its key PRNGKey(0), fold_in by step, split as
    `flow_matching_loss` splits it)."""
    key = jax.random.PRNGKey(0)
    draws = []
    for i in range(steps):
        t_key, eps_key = jax.random.split(jax.random.fold_in(key, i))
        t = jax.nn.sigmoid(jax.random.normal(t_key, (B,)))
        eps = jax.random.normal(eps_key, (B, P_TOK, J_TINY.in_channels), jnp.float32)
        draws.append((torch.from_numpy(np.array(t)), torch.from_numpy(np.array(eps))))
    feed = iter(draws)

    def loss_fn(p, cfg, batch, generator):
        t, eps = next(feed)
        return t_loss(p, cfg, batch, t=t, eps=eps)

    return loss_fn


@pytest.fixture(scope="module")
def loops():
    """The JAX loop and the port's on the same weights, data and draws."""
    params = init_flux_params(jax.random.PRNGKey(0), J_TINY, jnp.float32)
    want = j_loop(params, J_TINY, jax_stream(), JTrainConfig(**LOOP), log=lambda _: None)
    got = t_loop(to_torch(params), T_TINY, (to_torch(b) for b in jax_stream()),
                 TTrainConfig(**LOOP), loss_fn=jax_loop_draws(LOOP["total_steps"]),
                 log=lambda _: None)
    return want, got


def test_loop_losses_match_jax(loops):
    want, got = loops
    assert got["step"] == want["step"] == LOOP["total_steps"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5, atol=0)
    # the clip acted on every update (norms above max_grad_norm)
    assert len(got["grad_norms"]) == LOOP["total_steps"] // LOOP["grad_accum"]
    assert min(got["grad_norms"]) > LOOP["max_grad_norm"]


@pytest.mark.parametrize("tree", ["params", "ema"])
def test_loop_parameters_and_ema_match_jax(loops, tree):
    want, got = loops
    diff = np.abs(flat(tree_leaves(got[tree])) - flat(jax.tree.leaves(want[tree]))).max()
    assert diff <= 1e-6, diff


def test_loop_trains_and_ema_lags():
    """The JAX test's run (its weights, data, draws and config) on the port."""
    params = to_torch(init_flux_params(jax.random.PRNGKey(0), J_TINY, jnp.float32))
    p0 = tree_leaves(params)[0].clone()
    tc = TTrainConfig(total_steps=8, learning_rate=3e-3, warmup_steps=1, ema_decay=0.9,
                      log_every=100)
    out = t_loop(params, T_TINY, (to_torch(b) for b in jax_stream()), tc,
                 loss_fn=jax_loop_draws(8), log=lambda _: None)
    assert out["step"] == 8 and len(out["losses"]) == 8
    p1, e1 = tree_leaves(out["params"])[0], tree_leaves(out["ema"])[0]
    assert torch.equal(tree_leaves(params)[0], p0)  # the caller's tensors stay
    assert not torch.allclose(p0, p1)
    assert not torch.allclose(p1, e1)
    assert np.mean(out["losses"][-3:]) < np.mean(out["losses"][:3])


def test_grad_accum_updates_less_often():
    params = port_params()
    leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
    tc = TTrainConfig(total_steps=2, learning_rate=1e-3, warmup_steps=0, grad_accum=2,
                      ema_decay=0.0, log_every=100)
    opt = make_optimizer(tc, leaves)
    step = make_loop_step(T_TINY, tc, opt)
    stream = port_stream()
    ema = [x.detach().clone() for x in leaves]
    snap0 = [x.detach().clone() for x in leaves]
    _, norm = step(params, ema, next(stream), torch.Generator().manual_seed(1))
    assert norm is None and opt.count == 0 and opt.mini_step == 1
    assert all(torch.equal(a, b) for a, b in zip(snap0, leaves))
    _, norm = step(params, ema, next(stream), torch.Generator().manual_seed(1))
    assert norm is not None and opt.count == 1 and opt.mini_step == 0
    assert not all(torch.equal(a, b) for a, b in zip(snap0, leaves))


def test_checkpoint_resume(tmp_path):
    ckpt = str(tmp_path / "ckpts")
    tc = TTrainConfig(total_steps=6, learning_rate=1e-3, warmup_steps=0, ema_decay=0.9,
                      checkpoint_dir=ckpt, checkpoint_every=4, log_every=100)
    out1 = t_loop(port_params(), T_TINY, port_stream(),
                  TTrainConfig(**{**tc.__dict__, "total_steps": 4}), log=lambda _: None)
    assert latest_checkpoint(ckpt) == (4, os.path.join(ckpt, "step_00000004"))
    assert sorted(os.listdir(ckpt)) == ["step_00000004"]  # no temporary left behind
    logs = []
    out2 = t_loop(port_params(), T_TINY, port_stream(), tc, log=logs.append)
    assert any("resumed" in m and "step 4" in m for m in logs)
    assert out2["step"] == 6 and len(out2["losses"]) == 2
    assert not torch.allclose(tree_leaves(out1["params"])[0], tree_leaves(out2["params"])[0])


@pytest.mark.parametrize("accum,stop", [(1, 3), (2, 3)])
def test_resume_matches_uninterrupted_run(tmp_path, accum, stop):
    """Stopped at `stop` and resumed (with grad_accum 2, in the middle of an
    accumulation), the run ends bit for bit where an uninterrupted one does:
    the same per-step generators, data and optimizer state (moments, the
    schedule's count, the accumulator and its mini-step)."""
    base = dict(total_steps=6, learning_rate=3e-3, warmup_steps=2, ema_decay=0.9,
                grad_accum=accum, max_grad_norm=0.5, checkpoint_every=3, log_every=100)
    straight = t_loop(port_params(), T_TINY, port_stream(), TTrainConfig(**base),
                      log=lambda _: None)
    tc = TTrainConfig(**base, checkpoint_dir=str(tmp_path / "ckpts"))
    t_loop(port_params(), T_TINY, port_stream(), TTrainConfig(**{**tc.__dict__, "total_steps": stop}),
           log=lambda _: None)
    resumed = t_loop(port_params(), T_TINY, port_stream(), tc, log=lambda _: None)
    assert resumed["losses"] == straight["losses"][stop:]
    for key in ("params", "ema"):
        for s, r in zip(tree_leaves(straight[key]), tree_leaves(resumed[key])):
            assert torch.equal(s, r)


def test_step_seed_depends_on_seed_and_step_alone():
    assert step_seed(0, 3) == step_seed(0, 3)
    assert len({step_seed(s, i) for s in range(3) for i in range(50)}) == 150


def test_loop_refuses_mesh_arguments():
    """A mesh the parameters are not laid out over raises before any step
    (the loop over a mesh is held in `tests/test_torch_parallel.py`)."""
    from conceptattention_torch.parallel import make_mesh

    mesh = make_mesh(data=2, devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="laid out over"):
        t_loop(port_params(), T_TINY, port_stream(), TTrainConfig(total_steps=1), mesh=mesh)


def test_save_load_round_trip(tmp_path):
    """A tree of tensors and Python values comes back equal; with `like`,
    in like's dtypes; a save replaces the previous one whole; a structure
    that does not match `like` raises."""
    tree = {"w": torch.randn(3, 4), "h": torch.arange(6, dtype=torch.int8),
            "nested": [torch.ones(2, dtype=torch.bfloat16), {"count": 7, "none": None}],
            "pair": (torch.zeros(1), 0.5)}
    path = str(tmp_path / "ck" / "step_00000001")
    save_params(path, tree)
    back = load_params(path)
    assert torch.equal(back["w"], tree["w"]) and back["h"].dtype == torch.int8
    assert back["nested"][1] == {"count": 7, "none": None} and back["pair"][1] == 0.5
    like = dict(tree, w=torch.zeros(3, 4, dtype=torch.float64))
    assert load_params(path, like=like)["w"].dtype == torch.float64
    save_params(path, dict(tree, w=tree["w"] * 2))
    assert torch.equal(load_params(path)["w"], tree["w"] * 2)
    assert os.listdir(tmp_path / "ck") == ["step_00000001"]
    with pytest.raises(ValueError, match="keys"):
        load_params(path, like={"w": tree["w"]})
    with pytest.raises(ValueError, match="expected"):
        load_params(path, like=dict(tree, w=torch.zeros(4, 3)))
