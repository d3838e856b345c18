"""The CogVideoX block's LayerNorm entries (`kernels/layer_norm.py`) on the CPU.

On CPU tensors both entries run their plain version, which has to be the
video DiT's former eager arithmetic bit for bit (written out below as it
stood). The block has to call them once per stream it uses: the concept
branch normalises only the concept stream. The kernel itself is held
against the plain version on the card (`test_torch_cuda_kernels.py`).
"""

import pytest
import torch

from conceptattention_torch.kernels import launch_counts
from conceptattention_torch.kernels import layer_norm as ln
from conceptattention_torch.models.video import dit
from conceptattention_torch.ops.attention import ConceptAttentionSpec
from conceptattention_torch.ops.rope import embed_nd

torch.set_num_threads(2)  # six test workers share the host's cores


def eager_ln(x, w=None, b=None, eps=1e-5):
    """The video DiT's `_ln` as it was before the kernel."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).pow(2).mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if w is not None:
        out = out * w.float()
    if b is not None:
        out = out + b.float()
    return out.to(x.dtype)


def draw(seed, *shape, dtype=torch.bfloat16, loc=0.0):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=gen) + loc).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("affine", [True, False], ids=["affine", "plain"])
@pytest.mark.parametrize("modulated", [True, False], ids=["modulated", "unmodulated"])
@pytest.mark.parametrize("d", [64, 1920, 3072])
def test_plain_layer_norm_is_the_eager_arithmetic(d, modulated, affine, dtype):
    x = draw(0, 2, 5, d, dtype=dtype, loc=0.3)
    w, b = (draw(1, d, dtype=dtype, loc=1.0), draw(2, d, dtype=dtype)) if affine else (None, None)
    scale, shift = (draw(3, 2, d, dtype=dtype) * 0.1, draw(4, 2, d, dtype=dtype)) if modulated \
        else (None, None)
    want = eager_ln(x, w, b, 1e-5)
    if modulated:
        want = want * (1 + scale[:, None]) + shift[:, None]
    got = ln.layer_norm(x, w, b, 1e-5, scale=scale, shift=shift)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "plain"])
@pytest.mark.parametrize("heads,hd", [(3, 64), (2, 16)])
def test_plain_qk_layer_norm_is_the_eager_arithmetic(heads, hd, affine):
    b, l = 2, 7
    qkv = draw(5, b, l, 3 * heads * hd, loc=-0.2)
    params = [draw(6 + i, hd, loc=float(i % 2 == 0)) if affine else None for i in range(4)]
    h = qkv.reshape(b, l, 3, heads, hd).permute(2, 0, 3, 1, 4)
    want_q = eager_ln(h[0], params[0], params[1], 1e-6)
    want_k = eager_ln(h[1], params[2], params[3], 1e-6)
    q, k = ln.qk_layer_norm(qkv, heads, *params, eps=1e-6)
    assert q.shape == k.shape == (b, heads, l, hd)
    assert torch.equal(q, want_q) and torch.equal(k, want_k)


def test_entries_refuse_autograd_and_half_a_modulation():
    x = draw(0, 1, 3, 64)
    with pytest.raises(RuntimeError, match="layer_norm has no backward"):
        ln.layer_norm(x.clone().requires_grad_(True))
    with pytest.raises(RuntimeError, match="qk_layer_norm has no backward"):
        ln.qk_layer_norm(draw(1, 1, 3, 3 * 64).float().requires_grad_(True), 1)
    with pytest.raises(ValueError, match="scale and shift together"):
        ln.layer_norm(x, scale=draw(2, 1, 64))
    with torch.no_grad():
        ln.layer_norm(x.float().requires_grad_(True))


def test_launch_counts_name_the_layer_norm_entries():
    counts = launch_counts()
    assert counts["layer_norm"] == ln.layer_norm.launches
    assert counts["layer_norm (q/k)"] == ln.qk_layer_norm.launches


TINY = dict(num_attention_heads=2, attention_head_dim=16, in_channels=4, out_channels=4,
            time_embed_dim=8, text_embed_dim=16, num_layers=2, sample_width=8, sample_height=8,
            sample_frames=9, patch_size=2, max_text_seq_length=6,
            use_rotary_positional_embeddings=True)
B, P_TOK, T_LEN, C_PAD = 2, 48, 6, 6


def recorded(monkeypatch):
    """Record the rows each `layer_norm` and `qk_layer_norm` call of the
    video DiT sees: [(entry, rows of one batch entry)]."""
    calls = []
    plain, qk = ln.layer_norm, ln.qk_layer_norm

    def rec_ln(x, *a, **k):
        calls.append(("layer_norm", x.shape[1]))
        return plain(x, *a, **k)

    def rec_qk(qkv, *a, **k):
        calls.append(("qk_layer_norm", qkv.shape[1]))
        return qk(qkv, *a, **k)

    monkeypatch.setattr(dit, "layer_norm", rec_ln)
    monkeypatch.setattr(dit, "qk_layer_norm", rec_qk)
    return calls


@pytest.mark.parametrize("with_concepts", [True, False], ids=["concepts", "no-concepts"])
def test_block_normalises_each_used_stream_once(monkeypatch, with_concepts):
    """Per block: the video and text streams through each LayerNormZero and
    the q/k norm once; the concept stream likewise, and the concept branch's
    LayerNormZeros see the concept rows only (no video rows)."""
    cfg = dit.CogVideoXConfig(**TINY)
    params = dit.init_video_dit_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    d = cfg.hidden_size
    video, text, con = (draw(10 + i, B, n, d, dtype=torch.float32)
                        for i, n in enumerate((P_TOK, T_LEN, C_PAD)))
    temb = draw(13, B, cfg.time_embed_dim, dtype=torch.float32)
    ids = dit.make_video_ids(3, 4, 4, B)
    pe = embed_nd(torch.cat([torch.zeros(B, T_LEN, 3), ids], 1), cfg.rope_axes_dim, 10_000)
    cpe = embed_nd(torch.cat([torch.zeros(B, C_PAD, 3), ids], 1), cfg.rope_axes_dim, 10_000)
    calls = recorded(monkeypatch)
    dit._video_block(dit.layer(params["blocks"], 0), cfg, video, text,
                     con if with_concepts else None, temb, pe, cpe if with_concepts else None,
                     ConceptAttentionSpec())
    want = [("layer_norm", P_TOK), ("layer_norm", T_LEN),
            ("qk_layer_norm", P_TOK), ("qk_layer_norm", T_LEN)]
    if with_concepts:
        want += [("layer_norm", C_PAD), ("qk_layer_norm", C_PAD), ("layer_norm", C_PAD)]
    want += [("layer_norm", P_TOK), ("layer_norm", T_LEN)]
    assert calls == want


def test_forward_calls_per_layer_and_the_output_norms(monkeypatch):
    """A forward with concepts: 6 LayerNorm and 3 q/k launches a layer, and
    the two output norms over the video rows."""
    cfg = dit.CogVideoXConfig(**TINY)
    params = dit.init_video_dit_params(torch.Generator().manual_seed(0), cfg, torch.float32)
    calls = recorded(monkeypatch)
    video = draw(20, B, 3, 4, 8, 8, dtype=torch.float32)
    text = draw(21, B, T_LEN, 16, dtype=torch.float32)
    con = draw(22, B, C_PAD, 16, dtype=torch.float32)
    dit.video_dit_forward(params, cfg, video, text, torch.tensor([999.0, 500.0]), concepts=con)
    count = {e: sum(1 for c in calls if c[0] == e) for e in ("layer_norm", "qk_layer_norm")}
    assert count == {"layer_norm": 6 * cfg.num_layers + 2, "qk_layer_norm": 3 * cfg.num_layers}
    assert calls[-2:] == [("layer_norm", P_TOK), ("layer_norm", P_TOK)]
    assert sum(rows for e, rows in calls if e == "layer_norm") == cfg.num_layers * (
        2 * P_TOK + 2 * T_LEN + 2 * C_PAD) + 2 * P_TOK
