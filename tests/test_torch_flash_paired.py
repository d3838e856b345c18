"""The port's head-paired attention (K3) and K1 at head dim 64, on the CPU.

On CPU tensors `fused_concept_flash_attention_paired` runs its plain PyTorch
version. Here it is held against the JAX package's paired Pallas kernel in
interpret mode, and `fused_concept_flash_attention` at head dim 64 against
the JAX K1 kernel in interpret mode, on the same numpy inputs, in f32: the
CogVideoX head dim, 4 heads (two pairs), RoPE tables per batch row.
Tolerance: 1e-5 absolute and relative, for a softmax over at most 64 keys and
64-term dot products in f32, where the two sides differ in reduction order
and in online (tiled) versus one-pass softmax.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conceptattention_torch.kernels import flash_saliency as t_fs
from conceptattention_torch.ops import attention as t_attn
from conceptattention_torch.ops import rope as t_rope
from conceptattention_tpu.kernels import flash_saliency as j_fs
from conceptattention_tpu.ops import attention as j_attn
from conceptattention_tpu.ops import rope as j_rope

torch.set_num_threads(2)  # six test workers share the host's cores

TOL = dict(rtol=1e-5, atol=1e-5)
B, H, D = 2, 4, 64
T, P, C = 8, 48, 3  # txt, video, concepts: 59 real rows
S = 64
AXES = (16, 24, 24)  # CogVideoX's (t, h, w) split of head dim 64
BLOCK = 16  # JAX kernel tiles (interpret mode)
ABLATIONS = [(True, True), (True, False), (False, True), (False, False)]


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def video_ids(b):
    """A 3 x 4 x 4 (frame, y, x) grid, shifted per batch row."""
    f, y, x = np.meshgrid(np.arange(3), np.arange(4), np.arange(4), indexing="ij")
    ids = np.stack([f, y, x], -1).reshape(1, -1, 3).astype(np.float32)
    return ids + np.arange(b, dtype=np.float32)[:, None, None] * np.array([0, 2, 3], np.float32)


@pytest.fixture(scope="module")
def data():
    """q/k/v over [txt | video | concept | pad] (pad rows random, so masking
    keeps them out) and both packages' expanded tables for S rows."""
    ids = video_ids(B)
    txt_ids, con_ids = np.zeros((B, T, 3), np.float32), np.zeros((B, C, 3), np.float32)
    segs = []
    for front in (txt_ids, con_ids):
        both = np.concatenate([front, ids], 1)
        segs.append((t_rope.embed_nd(torch.from_numpy(both), AXES, 10_000),
                     j_rope.embed_nd(jnp.asarray(both), AXES, 10_000)))
    (t_pe, j_pe), (t_cpe, j_cpe) = segs
    q, k, v = (rand(i, B, H, S, D) for i in range(3))

    def tables(s, pe, cpe, expand):
        return expand([pe, (cpe[0][:, :, :C], cpe[1][:, :, :C])], s)

    return dict(
        qkv=(q, k, v),
        t_tab={s: tables(s, t_pe, t_cpe, t_fs.expand_rope_tables) for s in (S, T + P + C)},
        j_tab=tables(S, j_pe, j_cpe, j_fs.expand_rope_tables),
        t_pes=(t_pe, t_cpe), j_pes=(j_pe, j_cpe),
    )


def torch_args(data, s):
    return [torch.from_numpy(x[:, :, :s].copy()) for x in data["qkv"]] + list(data["t_tab"][s])


@pytest.mark.parametrize("cross,self_attention", ABLATIONS)
def test_plain_paired_matches_pallas_paired(data, cross, self_attention):
    """Every cross/self combination: rows that see nothing are exact zeros."""
    got = t_fs.fused_concept_flash_attention_paired(
        *torch_args(data, S), T, P, C, cross, self_attention)
    want = j_fs.fused_concept_flash_attention_paired(
        *(jnp.asarray(x) for x in data["qkv"]), *data["j_tab"], txt_len=T, img_len=P,
        concept_len=C, cross=cross, self_attention=self_attention, block_q=BLOCK,
        block_k=BLOCK, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    seen_by_nothing = T + P + (C if (cross or self_attention) else 0)
    np.testing.assert_array_equal(got[:, :, seen_by_nothing:].numpy(), 0.0)


def test_paired_ragged_tail(data):
    """The port appends concepts unpadded: S = 59 matches the paired Pallas
    kernel on the 64-row sequence, row for row."""
    s = T + P + C
    got = t_fs.fused_concept_flash_attention_paired(*torch_args(data, s), T, P, C)
    want = j_fs.fused_concept_flash_attention_paired(
        *(jnp.asarray(x) for x in data["qkv"]), *data["j_tab"], txt_len=T, img_len=P,
        concept_len=C, block_q=BLOCK, block_k=BLOCK, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, :, :s], **TOL)


@pytest.mark.parametrize("cross,self_attention", [(True, True), (False, True)])
def test_k1_at_head_dim_64_matches_pallas(data, cross, self_attention):
    q, k, v, cos, sin = torch_args(data, S)
    got = t_fs.fused_concept_flash_attention(q, k, v, T, P, C, cross, self_attention, cos, sin)
    want = j_fs.fused_concept_flash_attention(
        *(jnp.asarray(x) for x in data["qkv"]), txt_len=T, img_len=P, concept_len=C,
        cross=cross, self_attention=self_attention, block_q=BLOCK, block_k=BLOCK,
        interpret=True, rope_cos=data["j_tab"][0], rope_sin=data["j_tab"][1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pair_heads", [False, True])
def test_joint_attention_routes_d64_by_pair_heads(data, monkeypatch, pair_heads):
    """`joint_concept_attention_fused` takes K3 at head dim 64 with an even
    head count only when PAIR_HEADS is set, and either way matches the JAX
    package's two-SDPA path."""
    calls = {"paired": 0, "single": 0}
    paired, single = t_fs.fused_concept_flash_attention_paired, t_fs.fused_concept_flash_attention

    def count(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(t_fs, "fused_concept_flash_attention_paired", count("paired", paired))
    monkeypatch.setattr(t_fs, "fused_concept_flash_attention", count("single", single))
    monkeypatch.setattr(t_fs, "PAIR_HEADS", pair_heads)
    q, k, v = data["qkv"]
    cut = [(0, T), (T, T + P), (T + P, T + P + C)]
    segs = [tuple(x[:, :, a:b] for x in (q, k, v)) for a, b in cut]
    got = t_attn.joint_concept_attention(
        *[tuple(torch.from_numpy(x.copy()) for x in seg) for seg in segs], *data["t_pes"])
    want = j_attn.joint_concept_attention(
        *[tuple(jnp.asarray(x) for x in seg) for seg in segs], *data["j_pes"],
        j_attn.ConceptAttentionSpec(backend="xla"))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert calls == ({"paired": 1, "single": 0} if pair_heads else {"paired": 0, "single": 1})


@pytest.mark.parametrize("case", ["odd_heads", "head_dim", "no_tables", "one_table"])
def test_paired_contract_is_checked(case):
    """K3's contract (head dim 64, even heads, both tables) holds on every
    device: the plain version refuses what the kernel would."""
    h, d = (3, 64) if case == "odd_heads" else (2, 32) if case == "head_dim" else (2, 64)
    q = torch.zeros(1, h, 16, d)
    cos = sin = torch.ones(1, 16, d)
    if case == "no_tables":
        cos = sin = None
    elif case == "one_table":
        sin = None
    with pytest.raises(ValueError):
        t_fs.fused_concept_flash_attention_paired(q, q, q, cos, sin, 16, 0, 0)


def test_cpu_tensors_launch_no_kernel(data):
    before = (t_fs.fused_concept_flash_attention_paired.launches,
              t_fs.fused_concept_flash_attention.launches)
    t_fs.fused_concept_flash_attention_paired(*torch_args(data, S), T, P, C)
    assert (t_fs.fused_concept_flash_attention_paired.launches,
            t_fs.fused_concept_flash_attention.launches) == before
