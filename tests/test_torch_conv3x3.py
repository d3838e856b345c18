"""The port's 3x3 SAME convolution against the JAX package's, on the CPU.

On a CPU tensor `conv3x3_same` runs its plain PyTorch version (nine shifted
GEMMs with f32 accumulation, bias and optional swish on the f32 sum); here it
is held against the JAX Pallas kernel in interpret mode on the same numpy
inputs. f32 tolerance: 1e-5, for sums of up to 9 * 256 products taken in
another order. bf16 tolerance: 2**-7 relative, one bf16 rounding step of the
output, since an f32 sum in another order may round to the neighbouring bf16
value.
"""

import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from conceptattention_torch.kernels import conv3x3 as t_conv
from conceptattention_tpu.kernels import conv3x3 as j_conv

torch.set_num_threads(2)  # six test workers share the host's cores

CONV = dict(rtol=1e-5, atol=1e-5)


def inputs(seed, b, h, w, cin, cout):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wgt = (rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    return x, wgt, bias


def port(x, wgt, bias, swish=False, dtype=torch.float32):
    args = (torch.from_numpy(a).to(dtype) for a in (x, wgt, bias))
    return t_conv.conv3x3_same(*args, swish).float().numpy()


def jax_kernel(x, wgt, bias, swish=False, dtype=jnp.float32):
    out = j_conv.conv3x3_same(*(jnp.asarray(a, dtype) for a in (x, wgt, bias)),
                              fuse_swish=swish, interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize(
    "b,h,w,cin,cout",
    [
        (1, 16, 16, 128, 128),  # decoder top level (shape class)
        (1, 8, 16, 256, 128),   # channel-reducing resblock
        (2, 8, 8, 128, 256),    # batch > 1, channel-expanding
        (1, 24, 8, 128, 128),   # h not a power of two
    ],
)
def test_matches_pallas_kernel(b, h, w, cin, cout):
    x, wgt, bias = inputs(0, b, h, w, cin, cout)
    np.testing.assert_allclose(port(x, wgt, bias), jax_kernel(x, wgt, bias), **CONV)


def test_matches_in_bf16():
    x, wgt, bias = inputs(1, 1, 16, 16, 128, 128)
    # Round the inputs to bf16 once, so both sides convolve the same values.
    x, wgt, bias = (a.astype(ml_dtypes.bfloat16).astype(np.float32) for a in (x, wgt, bias))
    got = port(x, wgt, bias, dtype=torch.bfloat16)
    want = jax_kernel(x, wgt, bias, dtype=jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=2**-7, atol=1e-5)


def test_border_zeros_exact():
    """SAME border: a one-hot tap that reads the up-left neighbour gives an
    exact zero at the corner and copies the interior."""
    x = np.ones((1, 8, 8, 128), np.float32)
    wgt = np.zeros((3, 3, 128, 128), np.float32)
    wgt[0, 0, 0, 0] = 1.0
    bias = np.zeros(128, np.float32)
    got = port(x, wgt, bias)
    assert got[0, 0, 0, 0] == 0.0
    assert got[0, 1, 1, 0] == 1.0
    np.testing.assert_array_equal(got[0, 0, :, 0], 0.0)
    np.testing.assert_array_equal(got[0, :, 0, 0], 0.0)
    np.testing.assert_array_equal(got, jax_kernel(x, wgt, bias))


def test_fused_swish():
    x, wgt, _ = inputs(2, 1, 8, 8, 128, 128)
    bias = np.zeros(128, np.float32)
    got = port(x, wgt, bias, swish=True)
    np.testing.assert_allclose(got, jax_kernel(x, wgt, bias, swish=True), **CONV)
    plain = port(x, wgt, bias)
    np.testing.assert_allclose(got, plain / (1 + np.exp(-plain)), **CONV)


def _on(device, shape):
    # The gate reads only the shape and the device type.
    return types.SimpleNamespace(shape=shape, device=torch.device(device))


@pytest.mark.parametrize(
    "shape,cin,cout,want",
    [
        ((1, 16, 16, 128), 128, 128, True),
        ((1, 1024, 1024, 256), 256, 128, True),
        ((1, 16, 16, 96), 96, 128, False),     # cin not a multiple of 128
        ((1, 16, 16, 128), 128, 3, False),     # conv_out: 3 output channels
        ((1, 17, 16, 128), 128, 128, False),   # h not a multiple of 8
        ((1, 16, 4, 128), 128, 128, False),    # w below 8
    ],
)
def test_gate(shape, cin, cout, want):
    """The JAX gate's channel, height and width conditions, with "on a CUDA
    card" in place of the TPU-backend check."""
    assert t_conv.use_conv3x3_kernel(_on("cuda", shape), cin, cout) is want
    assert not t_conv.use_conv3x3_kernel(_on("cpu", shape), cin, cout)
    assert t_conv.use_conv3x3_kernel(torch.zeros(shape[:3] + (1,)), cin, cout) is False


def test_cpu_tensors_launch_no_kernel():
    before = t_conv.conv3x3_same.launches
    port(*inputs(3, 1, 8, 8, 128, 128))
    assert t_conv.conv3x3_same.launches == before


# (H = W, Cin, Cout) of the flux VAE decoder's 3x3 convs that the gate
# admits, at a 1024x1024 image: 31 convs over these eight shapes.
DECODER_SHAPES = [(128, 512, 512), (256, 512, 512), (512, 256, 256), (512, 512, 256),
                  (512, 512, 512), (1024, 128, 128), (1024, 256, 128), (1024, 256, 256)]


@pytest.mark.parametrize("res,cin,cout", DECODER_SHAPES)
def test_decoder_shapes_take_the_hopper_kernel(res, cin, cout):
    """Every decoder conv the gate admits takes the Hopper instance in bf16,
    as one 128-pixel row segment per block and 256 output channels where
    Cout >= 256."""
    assert t_conv.use_conv3x3_kernel(_on("cuda", (1, res, res, cin)), cin, cout)
    assert t_conv.conv3x3_instance(torch.bfloat16, cin, cout) == "hopper"
    assert t_conv.hopper_conv_tiles(res, cout) == (128, 256 if cout >= 256 else 128)


@pytest.mark.parametrize(
    "w,cin,cout,dtype,instance,tiles",
    [
        (16, 128, 128, torch.bfloat16, "hopper", (16, 128)),    # 16 x 8 pixel rectangles
        (24, 256, 128, torch.bfloat16, "hopper", (32, 128)),    # 32 x 4, ragged columns
        (13, 64, 136, torch.bfloat16, "hopper", (16, 128)),     # ragged M and N tiles
        (200, 192, 384, torch.bfloat16, "hopper", (128, 256)),  # two row segments, one ragged
        (16, 96, 128, torch.bfloat16, "generic", None),         # Cin % 64 != 0
        (16, 128, 132, torch.bfloat16, "generic", None),        # Cout % 8 != 0: refused there
        (16, 128, 256, torch.float32, "generic", None),
    ],
)
def test_conv_instance_dispatch(w, cin, cout, dtype, instance, tiles):
    """The card tests' shapes: which instance takes them, and the Hopper
    instance's (bw, bn)."""
    assert t_conv.conv3x3_instance(dtype, cin, cout) == instance
    if tiles is not None:
        assert t_conv.hopper_conv_tiles(w, cout) == tiles


def test_hopper_tiles_cover_each_row():
    """bw is a power of two that divides 128 and covers a whole row below
    128 columns; bw x (128 / bw) is always 128 pixels."""
    for w in range(1, 300):
        bw, _ = t_conv.hopper_conv_tiles(w, 128)
        assert bw & (bw - 1) == 0 and 128 % bw == 0
        assert bw >= min(w, 128) and (bw == 128 or bw < 2 * w)


def test_instances_on_cpu_run_plain():
    """On CPU tensors each instance wrapper is the plain version and
    launches nothing."""
    args = tuple(torch.from_numpy(a) for a in inputs(4, 1, 8, 8, 128, 128))
    fns = (t_conv.conv3x3_same, t_conv.conv3x3_same_hopper, t_conv.conv3x3_same_generic)
    before = [fn.launches for fn in fns]
    want = t_conv.conv3x3_same_plain(*args, True)
    for fn in fns:
        assert torch.equal(fn(*args, True), want)
    assert [fn.launches for fn in fns] == before
