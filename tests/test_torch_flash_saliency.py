"""The port's flash-saliency attention against the JAX package's, on the CPU.

On a CPU tensor `fused_concept_flash_attention` runs its plain PyTorch
version (the CUDA kernel's function with the same rounding points); here it
is held against the JAX Pallas kernel in interpret mode and against the JAX
package's two-SDPA `xla` path, on the same numpy inputs, in f32. Tolerance:
1e-5 absolute and relative, for a softmax over at most a few hundred keys and
dot products of up to 512 terms in f32, where the two sides differ in
reduction order and in online (tiled) versus one-pass softmax.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from conceptattention_torch.kernels import flash_saliency as t_fs
from conceptattention_torch.ops import attention as t_attn
from conceptattention_torch.ops import rope as t_rope
from conceptattention_tpu.kernels import flash_saliency as j_fs
from conceptattention_tpu.ops import attention as j_attn
from conceptattention_tpu.ops import packing as j_pack
from conceptattention_tpu.ops import rope as j_rope

torch.set_num_threads(2)  # six test workers share the host's cores

ATTN = dict(rtol=1e-5, atol=1e-5)
H, D = 2, 32
T, P, C = 8, 48, 3  # txt, img, concepts
AXES = (8, 12, 12)
BLOCK = 16  # JAX kernel tiles (interpret mode)
ABLATIONS = [(True, True), (True, False), (False, True), (False, False)]


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or ATTN))


def img_ids(b, shifts=None):
    ids = np.asarray(j_pack.make_img_ids(6, 8, b))  # 48 tokens
    if shifts is not None:
        ids = ids + np.asarray(shifts, np.float32)[:, None, :]
    return ids


def both_pe(ids_a, ids_b):
    """(port pe, jax pe) for the sequence [ids_a; ids_b]."""
    ids = np.concatenate([ids_a, ids_b], axis=1).astype(np.float32)
    return (t_rope.embed_nd(torch.from_numpy(ids), AXES, 10_000),
            j_rope.embed_nd(jnp.asarray(ids), AXES, 10_000))


def qkv_np(seed, b, l, d=D, h=H):
    return tuple(rand(seed + i, b, h, l, d) for i in range(3))


def to_t(xs):
    return tuple(torch.from_numpy(x) for x in xs)


def to_j(xs):
    return tuple(jnp.asarray(x) for x in xs)


@pytest.fixture(scope="module")
def data():
    """Per-segment q/k/v and RoPE tables for one batch row."""
    ids = img_ids(1)
    t_pe, j_pe = both_pe(np.zeros((1, T, 3), np.float32), ids)
    t_cpe, j_cpe = both_pe(np.zeros((1, C, 3), np.float32), ids)
    segs = {"txt": qkv_np(0, 1, T), "img": qkv_np(10, 1, P), "con": qkv_np(20, 1, C)}
    return segs, (t_pe, t_cpe), (j_pe, j_cpe)


def fused_inputs(data, s_total):
    """q/k/v over [txt | img | concept | pad] (pad rows random, so masking is
    what keeps them out) and both packages' expanded RoPE tables."""
    segs, (t_pe, t_cpe), (j_pe, j_cpe) = data
    pad = s_total - (T + P + C)
    q, k, v = (np.concatenate([segs["txt"][i], segs["img"][i], segs["con"][i],
                               rand(30 + i, 1, H, pad, D)], axis=2) for i in range(3))
    t_tab = t_fs.expand_rope_tables([t_pe, (t_cpe[0][:, :, :C], t_cpe[1][:, :, :C])], s_total)
    j_tab = j_fs.expand_rope_tables([j_pe, (j_cpe[0][:, :, :C], j_cpe[1][:, :, :C])], s_total)
    return (q, k, v), t_tab, j_tab


def test_expand_rope_tables_per_sample():
    """Per-batch-row tables (a shifted crop in row 1) in the interleaved pair
    layout, identity rotation on the pad rows."""
    ids = img_ids(2, shifts=[[0, 0, 0], [0, 5, 9]])
    t_pe, j_pe = both_pe(np.zeros((2, T, 3), np.float32), ids)
    t_cos, t_sin = t_fs.expand_rope_tables([t_pe], T + P + 5)
    j_cos, j_sin = j_fs.expand_rope_tables([j_pe], T + P + 5)
    # cos/sin of the same f32 angles: elementwise
    close(t_cos, j_cos, rtol=1e-6, atol=1e-6)
    close(t_sin, j_sin, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(t_cos[:, T + P:].numpy(), 1.0)
    np.testing.assert_array_equal(t_sin[:, T + P:].numpy(), 0.0)
    assert not torch.equal(t_cos[0], t_cos[1])


@pytest.mark.parametrize("cross,self_attention", ABLATIONS)
def test_plain_kernel_matches_pallas_kernel(data, cross, self_attention):
    """Every cross/self combination, RoPE in the kernel, padded concept rows:
    pad rows and rows that see nothing come out as exact zeros."""
    s = 64
    (q, k, v), t_tab, j_tab = fused_inputs(data, s)
    got = t_fs.fused_concept_flash_attention(
        *to_t((q, k, v)), T, P, C, cross, self_attention, *t_tab)
    want = j_fs.fused_concept_flash_attention(
        *to_j((q, k, v)), txt_len=T, img_len=P, concept_len=C, cross=cross,
        self_attention=self_attention, block_q=BLOCK, block_k=BLOCK, interpret=True,
        rope_cos=j_tab[0], rope_sin=j_tab[1])
    close(got, want)
    np.testing.assert_array_equal(got[:, :, T + P + C:].numpy(), 0.0)
    if not (cross or self_attention):
        np.testing.assert_array_equal(got[:, :, T + P:].numpy(), 0.0)


def test_ragged_tail_needs_no_padding(data):
    """The port appends concepts unpadded: S = 59 matches the Pallas kernel's
    output on the 64-row padded sequence, row for row."""
    (q, k, v), _, j_tab = fused_inputs(data, 64)
    s = T + P + C
    segs, (t_pe, t_cpe), _ = data
    t_tab = t_fs.expand_rope_tables([t_pe, (t_cpe[0][:, :, :C], t_cpe[1][:, :, :C])], s)
    got = t_fs.fused_concept_flash_attention(
        *to_t((q[:, :, :s], k[:, :, :s], v[:, :, :s])), T, P, C, True, True, *t_tab)
    want = j_fs.fused_concept_flash_attention(
        *to_j((q, k, v)), txt_len=T, img_len=P, concept_len=C,
        block_q=BLOCK, block_k=BLOCK, interpret=True,
        rope_cos=j_tab[0], rope_sin=j_tab[1])
    close(got, np.asarray(want)[:, :, :s])


@pytest.mark.parametrize("d,h,s", [(32, 2, 56), (128, 2, 48), (512, 1, 64)])
def test_head_dims_without_rope(d, h, s):
    """Head dims 32 and 128 (the DiT's) and 512 (the VAE mid-attention: one
    head, no RoPE, no concepts), as one vanilla attention over S keys."""
    q, k, v = qkv_np(40, 1, s, d=d, h=h)
    got = t_fs.fused_concept_flash_attention(*to_t((q, k, v)), s, 0, 0)
    want = j_fs.fused_concept_flash_attention(
        *to_j((q, k, v)), txt_len=s, img_len=0, concept_len=0,
        block_q=BLOCK, block_k=BLOCK, interpret=True)
    close(got, want)
    close(got, j_attn.sdpa(*to_j((q, k, v))))


def _compare_joint(got, want, with_extras):
    for g, w, name in zip(got[:3], want[:3], ("txt", "img", "concept")):
        if w is None:
            assert g is None, name
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **ATTN)
    if with_extras:
        assert set(got[3]) == set(want[3])
        for key in want[3]:
            np.testing.assert_allclose(got[3][key].numpy(), np.asarray(want[3][key]),
                                       err_msg=key, **ATTN)


@pytest.mark.parametrize("cross,self_attention", ABLATIONS)
def test_joint_concept_attention(data, cross, self_attention):
    """The port's default ("fused") joint attention against both JAX paths,
    outputs and the saliency extras (pre-RoPE q/v, head-form outputs, the
    value passthrough when both ablations are off)."""
    segs, t_pes, j_pes = data
    t_args = [to_t(segs["txt"]), to_t(segs["img"]), to_t(segs["con"]), *t_pes]
    j_args = [to_j(segs["txt"]), to_j(segs["img"]), to_j(segs["con"]), *j_pes]
    got = t_attn.joint_concept_attention(
        *t_args, t_attn.ConceptAttentionSpec(cross_attention=cross, self_attention=self_attention))
    pallas = j_fs.pallas_joint_concept_attention(
        *j_args, cross=cross, self_attention=self_attention,
        block_q=BLOCK, block_k=BLOCK, interpret=True)
    xla = j_attn.joint_concept_attention(
        *j_args, j_attn.ConceptAttentionSpec(cross_attention=cross, self_attention=self_attention))
    _compare_joint(got, pallas, with_extras=True)
    _compare_joint(got, xla, with_extras=False)
    if not (cross or self_attention):
        np.testing.assert_array_equal(got[3]["concept_out_h"].numpy(), segs["con"][2])
    sdpa_path = t_attn.joint_concept_attention(
        *t_args, t_attn.ConceptAttentionSpec(cross_attention=cross, self_attention=self_attention,
                                             backend="sdpa"))
    _compare_joint(got, [x.numpy() if x is not None else None for x in sdpa_path[:3]]
                   + [{k: x.numpy() for k, x in sdpa_path[3].items()}], with_extras=True)


def test_no_concepts_path(data):
    segs, t_pes, j_pes = data
    got = t_attn.joint_concept_attention(to_t(segs["txt"]), to_t(segs["img"]), None, t_pes[0], None)
    want = j_fs.pallas_joint_concept_attention(
        to_j(segs["txt"]), to_j(segs["img"]), None, j_pes[0], None,
        block_q=BLOCK, block_k=BLOCK, interpret=True)
    _compare_joint(got, want, with_extras=True)
    assert got[3] == {}


def test_per_sample_rope_ids():
    """Two batch rows with different image position ids (a shifted crop):
    the per-row tables rope each row with its own ids."""
    ids = img_ids(2, shifts=[[0, 0, 0], [0, 5, 9]])
    t_pe, j_pe = both_pe(np.zeros((2, T, 3), np.float32), ids)
    txt, img = qkv_np(50, 2, T), qkv_np(60, 2, P)
    got = t_attn.joint_concept_attention(to_t(txt), to_t(img), None, t_pe, None)
    want = j_attn.joint_concept_attention(to_j(txt), to_j(img), None, j_pe, None,
                                          j_attn.ConceptAttentionSpec(backend="xla"))
    _compare_joint(got, want, with_extras=False)


def test_cpu_tensors_launch_no_kernel(data):
    before = t_fs.fused_concept_flash_attention.launches
    (q, k, v), t_tab, _ = fused_inputs(data, 64)
    t_fs.fused_concept_flash_attention(*to_t((q, k, v)), T, P, C, True, True, *t_tab)
    assert t_fs.fused_concept_flash_attention.launches == before


@pytest.mark.parametrize("case", ["dtype", "head_dim", "segments", "rope_shape", "one_table"])
def test_kernel_input_checks(case):
    """What the CUDA wrapper refuses before it launches (checked here on CPU
    tensors, which the wrapper itself never sends to the kernel)."""
    b, s, d = 1, 40, 32
    q = torch.zeros(b, H, s, d, dtype=torch.bfloat16)
    cos = sin = torch.zeros(b, s, d)
    args = dict(txt_len=8, img_len=24, concept_len=3)
    if case == "dtype":
        q = q.float()
    elif case == "head_dim":
        q = torch.zeros(b, H, s, 48, dtype=torch.bfloat16)
        cos = sin = torch.zeros(b, s, 48)
    elif case == "segments":
        args["img_len"] = 40
    elif case == "rope_shape":
        cos = sin = torch.zeros(b, s + 1, d)
    elif case == "one_table":
        sin = None
    with pytest.raises((TypeError, ValueError)):
        t_fs._check_inputs(q, q, q, args["txt_len"], args["img_len"], args["concept_len"], cos, sin)


def _pallas_rope_rows(q, k, cos, sin, scale):
    """The JAX kernel's rotation and rounding, run in a Pallas kernel in
    interpret mode (`_pair_swap` rolls lanes, which only a kernel can do):
    q as `_flash_kernel` ropes its q tile (rotated and scaled in f32, then
    rounded), k through `_rot`. Rows [R, D], tables [R, D] f32."""
    def kernel(q_ref, k_ref, c_ref, s_ref, qo_ref, ko_ref):
        qf = q_ref[...].astype(jnp.float32)
        qo_ref[...] = ((qf * c_ref[...] + j_fs._pair_swap(qf) * s_ref[...]) * scale).astype(
            qo_ref.dtype)
        ko_ref[...] = j_fs._rot(k_ref[...], c_ref[...], s_ref[...])

    shape = jax.ShapeDtypeStruct(q.shape, q.dtype)
    return pl.pallas_call(kernel, out_shape=(shape, shape), interpret=True)(q, k, cos, sin)


@pytest.mark.parametrize("d", [32, 128])
def test_rope_rows_match_pallas_rotation(d):
    """`rope_qk_rows_plain` (the Hopper instance's pre-pass) against the JAX
    kernel's rotation and rounding, bf16 in and out, per-row tables: equal
    bit for bit."""
    b, h, s = 2, 2, 24
    rng = np.random.default_rng(11)
    q, k = (rng.standard_normal((b, h, s, d)).astype(ml_dtypes.bfloat16) for _ in range(2))
    ang = rng.uniform(0, 6.28, (b, s, d // 2)).astype(np.float32)
    cos = np.repeat(np.cos(ang), 2, axis=-1)
    sin = np.stack([-np.sin(ang), np.sin(ang)], axis=-1).reshape(b, s, d)
    got_q, got_k = t_fs.rope_qk_rows_plain(
        *(torch.from_numpy(x.astype(np.float32)).bfloat16() for x in (q, k)),
        torch.from_numpy(cos), torch.from_numpy(sin))
    rows = lambda x: np.broadcast_to(x[:, None], (b, h, s, d)).reshape(-1, d)  # noqa: E731
    want_q, want_k = _pallas_rope_rows(
        jnp.asarray(q.reshape(-1, d)), jnp.asarray(k.reshape(-1, d)),
        jnp.asarray(rows(cos)), jnp.asarray(rows(sin)), t_fs.LOG2E / np.sqrt(d))
    for got, want in ((got_q, want_q), (got_k, want_k)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy().reshape(-1, d),
                                      np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("cross,self_attention", ABLATIONS)
def test_prepass_then_attention_equals_plain(data, cross, self_attention):
    """The Hopper instance's decomposition: the pre-pass's rows, attended
    without tables at score scale 1, equal the plain attention with tables,
    exactly, in bf16 with a ragged tail and pad rows."""
    (q, k, v), t_tab, _ = fused_inputs(data, 64)
    q, k, v = (x.bfloat16() for x in to_t((q, k, v)))
    qr, kr = t_fs.rope_qk_rows_plain(q, k, *t_tab)
    got = t_fs.scaled_concept_attention_plain(qr, kr, v, T, P, C, cross, self_attention,
                                              score_scale=1.0)
    want = t_fs.fused_concept_flash_attention_plain(q, k, v, T, P, C, cross, self_attention, *t_tab)
    assert torch.equal(got, want)


@pytest.mark.parametrize("d,instance", [(32, "mma_sync"), (64, "hopper"), (128, "hopper"),
                                        (512, "hopper")])
def test_flash_instance(d, instance):
    """Head dims 128 (the flux DiT blocks), 64 (CogVideoX) and 512 (the VAE)
    take the Hopper kernel; 32 keeps the mma.sync kernel."""
    assert t_fs.flash_instance(d) == instance


@pytest.mark.parametrize("d,h,s,cross,self_attention,rope", [
    (64, 3, 70, True, True, True),     # CogVideoX's head dim: concepts, pad rows, tables
    (64, 3, 70, False, True, True),
    (64, 1, 59, True, False, True),    # ragged tail
    (512, 1, 70, True, True, False),   # the VAE's: one head, no tables, no concepts
])
def test_hopper_head_dims_match_pallas_kernel(d, h, s, cross, self_attention, rope):
    """What the Hopper instance computes at head dims 64 (with per-row RoPE
    tables) and 512 (without), as `fused_concept_flash_attention` gives it on
    CPU tensors, against the JAX kernel in interpret mode on the same numpy
    inputs."""
    b = 2 if rope else 1
    rng = np.random.default_rng(d + s)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))
    seg = (T, P, C) if rope else (s, 0, 0)
    kw, t_tab = {}, (None, None)
    if rope:
        ang = rng.uniform(0, 6.28, (b, s, d // 2)).astype(np.float32)
        cos = np.repeat(np.cos(ang), 2, axis=-1)
        sin = np.stack([-np.sin(ang), np.sin(ang)], axis=-1).reshape(b, s, d)
        t_tab = (torch.from_numpy(cos), torch.from_numpy(sin))
        kw = dict(rope_cos=jnp.asarray(cos), rope_sin=jnp.asarray(sin))
    got = t_fs.fused_concept_flash_attention(*to_t((q, k, v)), *seg, cross, self_attention, *t_tab)
    pad = -s % BLOCK  # the Pallas kernel takes whole blocks; its pad rows see nothing
    padded = [np.pad(x, ((0, 0), (0, 0), (0, pad), (0, 0))) for x in (q, k, v)]
    if rope:
        kw = {n: jnp.pad(x, ((0, 0), (0, pad), (0, 0))) for n, x in kw.items()}
    want = j_fs.fused_concept_flash_attention(
        *to_j(padded), txt_len=seg[0], img_len=seg[1], concept_len=seg[2], cross=cross,
        self_attention=self_attention, block_q=BLOCK, block_k=BLOCK, interpret=True, **kw)
    close(got, np.asarray(want)[:, :, :s])
    if rope:
        np.testing.assert_array_equal(got[:, :, T + P + C:].numpy(), 0.0)


def test_hopper_instance_on_cpu_runs_plain(data):
    """On CPU tensors the Hopper wrapper is the plain version and launches
    nothing."""
    (q, k, v), t_tab, _ = fused_inputs(data, 64)
    before = (t_fs.fused_concept_flash_attention.launches,
              t_fs.fused_concept_flash_attention_hopper.launches)
    args = (*to_t((q, k, v)), T, P, C, True, True, *t_tab)
    got = t_fs.fused_concept_flash_attention_hopper(*args)
    assert torch.equal(got, t_fs.fused_concept_flash_attention_plain(*args))
    assert (t_fs.fused_concept_flash_attention.launches,
            t_fs.fused_concept_flash_attention_hopper.launches) == before
