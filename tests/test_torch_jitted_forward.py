"""The port's `make_jitted_forward` against the JAX package's, on the CPU.

On CPU tensors the port's jitted forward calls `flux_forward`, so it equals
it bit for bit; against JAX's `make_jitted_forward` (a `jax.jit` over the
same closure) on the same numpy weights and inputs it holds to
`tests/test_torch_flux.py`'s forward tolerance, 1e-4 (a few hundred f32
matmul and softmax reductions taken in another order). The CUDA graph
capture and replay are card tests (`tests/test_torch_cuda_kernels.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conceptattention_torch import config as t_config
from conceptattention_torch.models.flux import dit as t_dit
from conceptattention_torch.weights.from_jax import flux_params_from_numpy
from conceptattention_tpu import config as j_config
from conceptattention_tpu.models.flux import dit as j_dit
from conceptattention_tpu.models.flux import params as j_params
from conceptattention_tpu.ops import packing as j_pack

torch.set_num_threads(2)  # six test workers share the host's cores

TOL = dict(rtol=1e-4, atol=1e-4)
CFG = t_config.configs["flux-tiny"].params
J_CFG = j_config.configs["flux-tiny"].params
T, GRID, C = 8, (4, 6), 3


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture(scope="module")
def params_np():
    tree = j_params.init_flux_params(jax.random.PRNGKey(0), J_CFG, jnp.float32)
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.02 * rng.standard_normal(a.shape)).astype(np.float32), tree)


def inputs_np(seed, concepts=True):
    p = GRID[0] * GRID[1]
    img_ids = np.asarray(j_pack.make_img_ids(*GRID, 1))
    out = {"img": rand(seed, 1, p, CFG.in_channels), "img_ids": img_ids,
           "txt": rand(seed + 1, 1, T, CFG.context_in_dim),
           "txt_ids": np.zeros((1, T, 3), np.float32),
           "timesteps": np.array([0.7], np.float32), "y": rand(seed + 2, 1, CFG.vec_in_dim)}
    if concepts:
        out.update(concepts=rand(seed + 3, 1, C, CFG.context_in_dim),
                   concept_ids=np.zeros((1, C, 3), np.float32),
                   concept_vec=np.zeros((1, CFG.vec_in_dim), np.float32))
    return out


def to_t(arrays):
    return {k: torch.from_numpy(np.array(a)) for k, a in arrays.items()}


def to_j(arrays):
    return {k: jnp.asarray(a) for k, a in arrays.items()}


def assert_same(got, want):
    assert (got[0] is None) == (want[0] is None)
    if want[0] is not None:
        assert torch.equal(got[0], want[0])
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        assert torch.equal(got[1][k], want[1][k])


@pytest.mark.parametrize("static", [{}, {"stop_after_multimodal_attentions": True}],
                         ids=["full", "stopped"])
def test_equals_flux_forward_bit_for_bit(params_np, static):
    params = flux_params_from_numpy(params_np)
    fwd = t_dit.make_jitted_forward(CFG, **static)
    for seed in (10, 20):
        x = to_t(inputs_np(seed))
        assert_same(fwd(params, **x), t_dit.flux_forward(params, CFG, **x, **static))
    assert fwd.graphs == {}  # nothing is captured on the CPU


@pytest.mark.parametrize("concepts", [True, False], ids=["concepts", "vanilla"])
def test_matches_jax_make_jitted_forward(params_np, concepts):
    x = inputs_np(30, concepts)
    got_pred, got_sal = t_dit.make_jitted_forward(CFG)(flux_params_from_numpy(params_np), **to_t(x))
    want_pred, want_sal = j_dit.make_jitted_forward(J_CFG)(params_np, **to_j(x))
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(want_pred), **TOL)
    assert set(got_sal) == set(want_sal) and bool(got_sal) == concepts
    for k in want_sal:
        np.testing.assert_allclose(got_sal[k].numpy(), np.asarray(want_sal[k]), **TOL)


def test_positional_array_raises_type_error(params_np):
    x = inputs_np(40)
    with pytest.raises(TypeError):
        j_dit.make_jitted_forward(J_CFG)(params_np, jnp.asarray(x["img"]))
    with pytest.raises(TypeError):
        t_dit.make_jitted_forward(CFG)(flux_params_from_numpy(params_np),
                                       torch.from_numpy(x["img"]))


def test_refuses_inputs_that_require_grad(params_np):
    """The forward carries no gradient (on the card it is a graph replay), so
    an input that requires grad under autograd raises, as the kernel entries
    do; under no_grad it runs."""
    params = flux_params_from_numpy(params_np)
    x = to_t(inputs_np(50))
    x["img"].requires_grad_(True)
    fwd = t_dit.make_jitted_forward(CFG)
    with pytest.raises(RuntimeError, match="make_jitted_forward has no backward"):
        fwd(params, **x)
    with torch.no_grad():
        pred, _ = fwd(params, **x)
    assert not pred.requires_grad
