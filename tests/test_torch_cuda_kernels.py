"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker `cuda`) and skips without one.
The file imports torch only, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernels.py

Tolerance: the kernels and their plain versions take the same bf16 inputs and
round at the same points, and differ in the order of f32 sums and, for
attention, in an online versus a one-pass softmax. So an output may land one
bf16 rounding step away: the limit is 2**-7 of the largest value, one to two
bf16 steps there. f32 convolution holds to 1e-4 of it.
"""

import pytest
import torch

from conceptattention_torch.kernels import conv3x3 as conv
from conceptattention_torch.kernels import flash_saliency as fs
from conceptattention_torch.kernels import ring_rdma as rr

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the CPU path is covered by the parity tests")
    return torch.device("cuda")


def bf16_limit(want):
    return 2.0**-7 * want.float().abs().max().item()


def rope_tables(gen, b, s, d, dev):
    ang = torch.rand(b, s, d // 2, generator=gen, device=dev) * 6.28
    c, sn = torch.cos(ang), torch.sin(ang)
    return (c.repeat_interleave(2, -1).contiguous(),
            torch.stack([-sn, sn], -1).reshape(b, s, d).contiguous())


@pytest.mark.parametrize(
    "b,h,s,d,t,p,c,cross,self_attention,rope",
    [
        (1, 2, 100, 32, 20, 70, 3, True, True, True),     # ragged tail, pad rows
        (2, 3, 200, 128, 40, 150, 5, True, False, True),  # per-row tables
        (1, 2, 200, 128, 40, 150, 5, False, True, True),
        (1, 2, 200, 128, 40, 150, 5, False, False, True),  # concept rows see nothing
        (2, 4, 300, 64, 26, 200, 26, True, True, True),  # CogVideoX head dim, ragged tail
        (1, 2, 190, 64, 26, 150, 10, False, True, True),
        (1, 2, 130, 128, 130, 0, 0, True, True, False),  # no tables, ragged tail
        (1, 1, 1000, 512, 1000, 0, 0, True, True, False),  # VAE mid-attention class
    ],
)
def test_flash_kernel_matches_plain(dev, b, h, s, d, t, p, c, cross, self_attention, rope):
    gen = torch.Generator(dev).manual_seed(0)
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev).bfloat16() for _ in range(3))
    tables = rope_tables(gen, b, s, d, dev) if rope else (None, None)
    args = (q, k, v, t, p, c, cross, self_attention, *tables)
    before = fs.fused_concept_flash_attention.launches
    got = fs.fused_concept_flash_attention(*args)
    torch.cuda.synchronize()
    assert fs.fused_concept_flash_attention.launches == before + 1
    want = fs.fused_concept_flash_attention_plain(*args)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= bf16_limit(want)
    seen_by_nothing = t + p + (c if (cross or self_attention) else 0)
    assert torch.count_nonzero(got[:, :, seen_by_nothing:]).item() == 0


@pytest.mark.parametrize("cross,self_attention", [(True, True), (True, False), (False, True),
                                                  (False, False)])
def test_paired_kernel_matches_plain(dev, cross, self_attention):
    """K3 at head dim 64 on 4 heads (two pairs, per-row tables), a ragged
    tail and pad rows, against its plain version and against K1."""
    b, h, s, d, t, p, c = 2, 4, 300, 64, 26, 200, 26
    gen = torch.Generator(dev).manual_seed(3)
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev).bfloat16() for _ in range(3))
    cos, sin = rope_tables(gen, b, s, d, dev)
    before = (fs.fused_concept_flash_attention_paired.launches,
              fs.fused_concept_flash_attention.launches)
    got = fs.fused_concept_flash_attention_paired(q, k, v, cos, sin, t, p, c, cross, self_attention)
    torch.cuda.synchronize()
    assert (fs.fused_concept_flash_attention_paired.launches,
            fs.fused_concept_flash_attention.launches) == (before[0] + 1, before[1])
    want = fs.fused_concept_flash_attention_paired_plain(
        q, k, v, cos, sin, t, p, c, cross, self_attention)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= bf16_limit(want)
    single = fs.fused_concept_flash_attention(q, k, v, t, p, c, cross, self_attention, cos, sin)
    assert (got.float() - single.float()).abs().max().item() <= bf16_limit(want)
    seen_by_nothing = t + p + (c if (cross or self_attention) else 0)
    assert torch.count_nonzero(got[:, :, seen_by_nothing:]).item() == 0


@pytest.mark.parametrize("case", ["odd_heads", "head_dim", "no_tables"])
def test_paired_kernel_refuses_bad_inputs(dev, case):
    h, d = (3, 64) if case == "odd_heads" else (2, 128) if case == "head_dim" else (2, 64)
    q = torch.zeros(1, h, 64, d, device=dev, dtype=torch.bfloat16)
    cos = sin = torch.ones(1, 64, d, device=dev)
    if case == "no_tables":
        cos = sin = None
    before = fs.fused_concept_flash_attention_paired.launches
    with pytest.raises(ValueError):
        fs.fused_concept_flash_attention_paired(q, q, q, cos, sin, 64, 0, 0)
    assert fs.fused_concept_flash_attention_paired.launches == before


def test_flash_kernel_refuses_bad_inputs(dev):
    q = torch.zeros(1, 2, 64, 32, device=dev)
    with pytest.raises(TypeError):
        fs.fused_concept_flash_attention(q, q, q, 64, 0, 0)
    q = torch.zeros(1, 2, 64, 48, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        fs.fused_concept_flash_attention(q, q, q, 64, 0, 0)


@pytest.mark.parametrize(
    "b,h,s,d,t,p,c,cross,self_attention,rope",
    [
        (1, 2, 100, 32, 20, 70, 3, True, True, True),     # ragged tail, pad rows
        (2, 3, 200, 128, 40, 150, 5, True, False, True),  # per-row tables
        (1, 2, 200, 128, 40, 150, 5, False, False, True),  # concept rows see nothing
        (2, 4, 300, 64, 26, 200, 26, False, True, True),
        (1, 2, 130, 128, 130, 0, 0, True, True, False),  # no tables: the scale after the sums
        (1, 2, 100, 32, 20, 70, 3, True, True, False),
    ],
)
def test_int8_kernel_matches_plain(dev, b, h, s, d, t, p, c, cross, self_attention, rope):
    """K1b (pre-pass and main kernel) against its plain version, and the
    pre-pass's int8 rows and scales equal to the plain quantizer's."""
    gen = torch.Generator(dev).manual_seed(2)
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev) for _ in range(3))
    q, k, v = (3 * q).bfloat16(), k.bfloat16(), v.bfloat16()
    tables = rope_tables(gen, b, s, d, dev) if rope else (None, None)
    args = (q, k, v, t, p, c, cross, self_attention, *tables)
    before = (fs.fused_concept_flash_attention_int8.launches, fs.fused_concept_flash_attention.launches)
    got = fs.fused_concept_flash_attention(*args, int8_qk=True)
    torch.cuda.synchronize()
    assert (fs.fused_concept_flash_attention_int8.launches,
            fs.fused_concept_flash_attention.launches) == (before[0] + 1, before[1])
    want = fs.fused_concept_flash_attention_plain(*args, int8_qk=True)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= bf16_limit(want)
    seen_by_nothing = t + p + (c if (cross or self_attention) else 0)
    assert torch.count_nonzero(got[:, :, seen_by_nothing:]).item() == 0
    for got_part, want_part in zip(fs.quantize_qk_rows_cuda(q, k, *tables),
                                   fs.quantize_qk_rows_plain(q, k, *tables)):
        assert torch.equal(got_part, want_part)


@pytest.mark.parametrize(
    "b,h,s,t,p,c,cross,self_attention,rope",
    [
        (1, 2, 300, 40, 250, 5, True, True, True),      # S not a multiple of 128, pad rows
        (1, 2, 150, 40, 80, 20, True, True, True),      # concepts 120..140 straddle key tile 128
        (1, 2, 150, 40, 80, 20, True, False, True),
        (1, 2, 150, 40, 80, 20, False, True, True),
        (1, 2, 150, 40, 80, 20, False, False, True),    # concept rows see nothing
        (2, 3, 391, 60, 300, 17, True, True, True),     # B=2 with per-row tables
        (1, 2, 300, 300, 0, 0, True, True, False),      # no tables, ragged tail
        (1, 2, 270, 40, 200, 9, True, True, False),     # no tables, concepts
    ],
)
def test_hopper_flash_kernel_matches_plain(dev, b, h, s, t, p, c, cross, self_attention, rope):
    """K1 at head dim 128 goes through the Hopper instance: its counter and
    K1's move by one, the output holds to the plain version, pad rows are
    exact zeros, and the RoPE pre-pass equals its plain version bit for bit."""
    d = 128
    gen = torch.Generator(dev).manual_seed(9)
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev) for _ in range(3))
    q, k, v = (3 * q).bfloat16(), k.bfloat16(), v.bfloat16()
    tables = rope_tables(gen, b, s, d, dev) if rope else (None, None)
    args = (q, k, v, t, p, c, cross, self_attention, *tables)
    assert fs.flash_instance(d) == "hopper"
    before = (fs.fused_concept_flash_attention.launches,
              fs.fused_concept_flash_attention_hopper.launches)
    got = fs.fused_concept_flash_attention(*args)
    torch.cuda.synchronize()
    assert (fs.fused_concept_flash_attention.launches,
            fs.fused_concept_flash_attention_hopper.launches) == (before[0] + 1, before[1] + 1)
    want = fs.fused_concept_flash_attention_plain(*args)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= bf16_limit(want)
    seen_by_nothing = t + p + (c if (cross or self_attention) else 0)
    assert torch.count_nonzero(got[:, :, seen_by_nothing:]).item() == 0
    if rope:
        for got_part, want_part in zip(fs.rope_qk_rows_cuda(q, k, *tables),
                                       fs.rope_qk_rows_plain(q, k, *tables)):
            assert torch.equal(got_part, want_part)


HOPPER_D64_CASES = [
    (1, 2, 300, 40, 250, 5, True, True, True),      # S not a multiple of 128, pad rows
    (1, 2, 150, 40, 80, 20, True, True, True),      # concepts 120..140 straddle key tile 128
    (1, 2, 150, 40, 80, 20, True, False, True),
    (1, 2, 150, 40, 80, 20, False, True, True),
    (1, 2, 150, 40, 80, 20, False, False, True),    # concept rows see nothing
    (2, 3, 391, 60, 300, 17, True, True, True),     # B=2 with per-row tables, odd head count
    (2, 3, 300, 300, 0, 0, True, True, False),      # no tables, ragged tail, odd head count
    (1, 2, 270, 40, 200, 9, True, True, False),     # no tables, concepts
    (1, 1, 1300, 30, 1200, 50, True, True, True),   # 11 key tiles: the 4-stage ring wraps
    (2, 3, 1370, 30, 1250, 50, True, True, True),   # the ring wraps at B=2, odd head count
    (2, 3, 1370, 30, 1250, 50, False, True, True),
]


@pytest.mark.parametrize("b,h,s,t,p,c,cross,self_attention,rope", HOPPER_D64_CASES)
def test_hopper_flash_kernel_d64_matches_plain(dev, b, h, s, t, p, c, cross, self_attention, rope):
    """K1 at head dim 64 (the CogVideoX blocks) goes through the Hopper
    instance: its counter and K1's move by one,
    the output holds to the plain version, pad rows are exact zeros, and the
    RoPE pre-pass equals its plain version bit for bit."""
    d = 64
    gen = torch.Generator(dev).manual_seed(10)
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev) for _ in range(3))
    q, k, v = (3 * q).bfloat16(), k.bfloat16(), v.bfloat16()
    tables = rope_tables(gen, b, s, d, dev) if rope else (None, None)
    args = (q, k, v, t, p, c, cross, self_attention, *tables)
    assert fs.flash_instance(d) == "hopper"
    before = (fs.fused_concept_flash_attention.launches,
              fs.fused_concept_flash_attention_hopper.launches)
    got = fs.fused_concept_flash_attention(*args)
    torch.cuda.synchronize()
    assert (fs.fused_concept_flash_attention.launches,
            fs.fused_concept_flash_attention_hopper.launches) == (before[0] + 1, before[1] + 1)
    want = fs.fused_concept_flash_attention_plain(*args)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= bf16_limit(want)
    seen_by_nothing = t + p + (c if (cross or self_attention) else 0)
    assert torch.count_nonzero(got[:, :, seen_by_nothing:]).item() == 0
    if rope:
        for got_part, want_part in zip(fs.rope_qk_rows_cuda(q, k, *tables),
                                       fs.rope_qk_rows_plain(q, k, *tables)):
            assert torch.equal(got_part, want_part)


@pytest.mark.parametrize("b", [1, 2])
def test_hopper_flash_kernel_d512_matches_plain(dev, b):
    """K1 at head dim 512 (the flux VAE's mid-attention: one head, no tables,
    no concepts) at a ragged S goes through the Hopper instance (four
    128-column chunks, 64-key tiles) and holds to the plain version."""
    s, d = 4096 + 37, 512
    gen = torch.Generator(dev).manual_seed(12)
    q, k, v = (torch.randn(b, 1, s, d, generator=gen, device=dev) for _ in range(3))
    q, k, v = (3 * q).bfloat16(), k.bfloat16(), v.bfloat16()
    before = (fs.fused_concept_flash_attention.launches,
              fs.fused_concept_flash_attention_hopper.launches)
    got = fs.fused_concept_flash_attention(q, k, v, s, 0, 0)
    torch.cuda.synchronize()
    assert (fs.fused_concept_flash_attention.launches,
            fs.fused_concept_flash_attention_hopper.launches) == (before[0] + 1, before[1] + 1)
    want = fs.fused_concept_flash_attention_plain(q, k, v, s, 0, 0)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= bf16_limit(want)


@pytest.mark.parametrize("d", [64, 512])
def test_head_dims_64_and_512_take_the_hopper_instance(dev, d):
    """Head dims 64 (CogVideoX) and 512 (the VAE) launch the Hopper kernel."""
    q = torch.randn(1, 1, 70, d, device=dev).bfloat16()
    before = fs.fused_concept_flash_attention_hopper.launches
    fs.fused_concept_flash_attention(q, q, q, 70, 0, 0)
    torch.cuda.synchronize()
    assert fs.flash_instance(d) == "hopper"
    assert fs.fused_concept_flash_attention_hopper.launches == before + 1


@pytest.mark.parametrize("d", [32])
def test_other_head_dims_stay_on_mma_sync(dev, d):
    """Head dim 32 keeps the mma.sync kernel."""
    q = torch.randn(1, 1, 70, d, device=dev).bfloat16()
    before = fs.fused_concept_flash_attention_hopper.launches
    fs.fused_concept_flash_attention(q, q, q, 70, 0, 0)
    torch.cuda.synchronize()
    assert fs.flash_instance(d) == "mma_sync"
    assert fs.fused_concept_flash_attention_hopper.launches == before


@pytest.mark.parametrize("d", [64, 512])
def test_hopper_flash_kernel_raises_without_fallback(dev, d):
    """A head-dim-64 or -512 call the Hopper kernel cannot take (q not
    16-byte aligned for TMA) raises; it is not sent to the mma.sync kernel or
    the plain version, and no counter moves."""
    buf = torch.zeros(70 * d + 1, device=dev, dtype=torch.bfloat16)
    q = buf[1:].view(1, 1, 70, d)  # contiguous, 2 bytes off alignment
    k = torch.zeros_like(q)
    before = (fs.fused_concept_flash_attention.launches,
              fs.fused_concept_flash_attention_hopper.launches)
    with pytest.raises(ValueError, match="aligned"):
        fs.fused_concept_flash_attention(q, k, k, 70, 0, 0)
    assert (fs.fused_concept_flash_attention.launches,
            fs.fused_concept_flash_attention_hopper.launches) == before


def test_int8_kernel_refuses_bad_inputs(dev):
    q = torch.zeros(1, 1, 64, 512, device=dev, dtype=torch.bfloat16)  # the VAE's head dim
    before = fs.fused_concept_flash_attention_int8.launches
    with pytest.raises(ValueError):
        fs.fused_concept_flash_attention(q, q, q, 64, 0, 0, int8_qk=True)
    assert fs.fused_concept_flash_attention_int8.launches == before


@pytest.mark.parametrize("m", [1, 3, 17])
def test_int8_gemm_pads_short_inputs(dev, m):
    """cuBLASLt's int8 GEMM takes more than 16 rows: fewer are padded with
    zero rows, and the int32 product is exact, with the weight stored
    column-major (as the quantizers store it)."""
    from conceptattention_torch.ops.quant import int8_matmul

    gen = torch.Generator(dev).manual_seed(4)
    x = torch.randint(-127, 128, (m, 3072), generator=gen, device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (3072, 256), generator=gen, device=dev, dtype=torch.int8)
    got = int8_matmul(x, w.t().contiguous().t())
    assert got.dtype == torch.int32 and got.shape == (m, 256)
    assert torch.equal(got.double(), x.double() @ w.double())


def test_int8_gemm_refuses_row_major_weight(dev):
    """A row-major weight would send the GEMM to its slow fallback: refused."""
    from conceptattention_torch.ops.quant import int8_matmul

    x = torch.zeros(32, 256, device=dev, dtype=torch.int8)
    with pytest.raises(ValueError, match="column-major"):
        int8_matmul(x, torch.zeros(256, 64, device=dev, dtype=torch.int8))


@pytest.mark.parametrize(
    "b,hh,ww,cin,cout,dtype,swish",
    [
        (1, 16, 16, 128, 128, torch.bfloat16, False),
        (2, 8, 24, 256, 128, torch.bfloat16, True),
        (1, 9, 13, 64, 136, torch.bfloat16, False),  # ragged M and N tiles
        (1, 16, 16, 128, 256, torch.float32, False),
        (2, 8, 24, 256, 128, torch.float32, True),
    ],
)
def test_conv_kernel_matches_plain(dev, b, hh, ww, cin, cout, dtype, swish):
    gen = torch.Generator(dev).manual_seed(1)
    x = torch.randn(b, hh, ww, cin, generator=gen, device=dev).to(dtype)
    w = (torch.randn(3, 3, cin, cout, generator=gen, device=dev) / (9 * cin) ** 0.5).to(dtype)
    bias = (0.1 * torch.randn(cout, generator=gen, device=dev)).to(dtype)
    before = conv.conv3x3_same.launches
    got = conv.conv3x3_same(x, w, bias, swish)
    torch.cuda.synchronize()
    assert conv.conv3x3_same.launches == before + 1
    want = conv.conv3x3_same_plain(x, w, bias, swish)
    limit = bf16_limit(want) if dtype == torch.bfloat16 else 1e-4 * want.abs().max().item()
    assert got.dtype == dtype and (got.float() - want.float()).abs().max().item() <= limit


@pytest.mark.parametrize(
    "b,hh,ww,cin,cout,dtype,swish,instance",
    [
        (1, 8, 128, 128, 128, torch.bfloat16, False, "hopper"),
        (1, 4, 128, 256, 256, torch.bfloat16, True, "hopper"),
        (1, 3, 128, 512, 512, torch.bfloat16, True, "hopper"),
        (1, 4, 256, 128, 128, torch.bfloat16, True, "hopper"),
        (1, 3, 256, 512, 256, torch.bfloat16, False, "hopper"),
        (2, 2, 256, 256, 512, torch.bfloat16, True, "hopper"),
        (1, 16, 16, 128, 128, torch.bfloat16, False, "hopper"),   # a 16 x 8 pixel rectangle
        (2, 8, 24, 256, 128, torch.bfloat16, True, "hopper"),     # 32 x 4, ragged columns
        (1, 9, 13, 64, 136, torch.bfloat16, False, "hopper"),     # ragged M and N tiles
        (1, 5, 200, 192, 384, torch.bfloat16, False, "hopper"),   # W past one row segment
        (1, 8, 16, 96, 128, torch.bfloat16, True, "generic"),     # Cin % 64 != 0
        (1, 8, 16, 128, 128, torch.float32, False, "generic"),
    ],
)
def test_conv_kernel_instances(dev, b, hh, ww, cin, cout, dtype, swish, instance):
    """Each shape takes the instance `conv3x3_instance` names (its counter
    and the sum move by one, the other instance's does not) and holds to the
    plain version."""
    assert conv.conv3x3_instance(dtype, cin, cout) == instance
    gen = torch.Generator(dev).manual_seed(2)
    x = torch.randn(b, hh, ww, cin, generator=gen, device=dev).to(dtype)
    w = (torch.randn(3, 3, cin, cout, generator=gen, device=dev) / (9 * cin) ** 0.5).to(dtype)
    bias = (0.1 * torch.randn(cout, generator=gen, device=dev)).to(dtype)
    counters = (conv.conv3x3_same, conv.conv3x3_same_hopper, conv.conv3x3_same_generic)
    before = [fn.launches for fn in counters]
    got = conv.conv3x3_same(x, w, bias, swish)
    torch.cuda.synchronize()
    moved = [fn.launches - n for fn, n in zip(counters, before)]
    assert moved == [1, int(instance == "hopper"), int(instance == "generic")]
    want = conv.conv3x3_same_plain(x, w, bias, swish)
    limit = bf16_limit(want) if dtype == torch.bfloat16 else 1e-4 * want.abs().max().item()
    assert got.dtype == dtype and (got.float() - want.float()).abs().max().item() <= limit


def test_conv_kernel_refuses_bad_inputs(dev):
    x = torch.zeros(1, 8, 8, 48, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(3, 3, 48, 128, device=dev, dtype=torch.bfloat16)
    b = torch.zeros(128, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # Cin not a multiple of 32
        conv.conv3x3_same(x, w, b)
    with pytest.raises(TypeError):
        conv.conv3x3_same(x.half(), w.half(), b.half())
    with pytest.raises(ValueError):  # the Hopper instance refuses f32
        conv.conv3x3_same_hopper(x.float(), w.float(), b.float())


def ring_inputs(gen, n, b, h, lc, d, dev, chunk_offsets=False):
    """Whole [B, H, N*Lc, D] bf16 q (at 3x scale: a peaked softmax), k, v,
    and their per-rank shards; with `chunk_offsets` each chunk's values sit
    4 units apart, so a rank that reads another chunk's slot is far off."""
    q, k, v = (torch.randn(b, h, n * lc, d, generator=gen, device=dev) for _ in range(3))
    if chunk_offsets:
        offset = (4.0 * torch.arange(n, device=dev)).repeat_interleave(lc)[None, None, :, None]
        v = v + offset
        k = k + 0.25 * offset
    q, k, v = (3 * q).bfloat16(), k.bfloat16(), v.bfloat16()

    def split(x):
        return [x[:, :, r * lc:(r + 1) * lc].contiguous() for r in range(n)]

    return (q, k, v), (split(q), split(k), split(v))


@pytest.mark.parametrize(
    "n,b,h,lc,d,t,p,c,cross,self_attention",
    [
        (1, 1, 2, 100, 32, 20, 70, 3, True, True),      # one rank, pad rows
        (2, 2, 3, 67, 128, 20, 100, 5, True, False),    # ragged Lc
        (2, 1, 2, 64, 64, 16, 96, 8, False, True),
        (3, 1, 2, 50, 64, 10, 120, 6, True, True),       # odd ring
        (4, 1, 2, 75, 64, 20, 200, 10, True, True),      # concepts split across chunks 2 and 3
        (4, 1, 2, 75, 128, 20, 200, 10, False, True),
        (4, 2, 2, 75, 32, 20, 200, 10, True, False),
        (4, 1, 2, 75, 128, 20, 200, 10, False, False),  # concept rows see nothing
        (4, 1, 3, 1089, 128, 256, 4096, 3, True, True),  # the flux double block's chunks, 3 heads
    ],
)
def test_ring_kernel_matches_plain(dev, n, b, h, lc, d, t, p, c, cross, self_attention):
    """K4 on a virtual ring of N ranks on one card against its plain version,
    and padded rows exactly zero."""
    gen = torch.Generator(dev).manual_seed(5)
    _, (qs, ks, vs) = ring_inputs(gen, n, b, h, lc, d, dev)
    kw = dict(masked=True, txt_len=t, img_len=p, concept_len=c, cross=cross,
              self_attention=self_attention)
    before = (rr.ring_attention_rdma.launches, rr.ring_attention_rdma.step_launches)
    got = rr.ring_attention_rdma(qs, ks, vs, **kw)
    torch.cuda.synchronize()
    assert (rr.ring_attention_rdma.launches, rr.ring_attention_rdma.step_launches) == (
        before[0] + 1, before[1] + n)
    want = torch.cat(rr.ring_attention_rdma_plain(qs, ks, vs, **kw), dim=2)
    got = torch.cat(got, dim=2)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert (got.float() - want.float()).abs().max().item() <= bf16_limit(want)
    seen_by_nothing = t + p + (c if (cross or self_attention) else 0)
    assert torch.count_nonzero(got[:, :, seen_by_nothing:]).item() == 0


@pytest.mark.parametrize("n", [2, 4, 5])
def test_ring_kernel_slot_reuse(dev, n):
    """Unmasked ring with each chunk's values 4 units apart: a hop that lands
    in a slot still being read, or a step that reads a stale slot, moves the
    output by whole units. Many heads keep each step long enough for the
    copies to race it."""
    b, h, lc, d = 2, 16, 256, 64
    gen = torch.Generator(dev).manual_seed(6)
    (q, k, v), (qs, ks, vs) = ring_inputs(gen, n, b, h, lc, d, dev, chunk_offsets=True)
    for _ in range(3):
        got = torch.cat(rr.ring_attention_rdma(qs, ks, vs), dim=2)
        torch.cuda.synchronize()
        want = torch.cat(rr.ring_attention_rdma_plain(qs, ks, vs), dim=2)
        assert (got.float() - want.float()).abs().max().item() <= bf16_limit(want)
    dense = fs.fused_concept_flash_attention_plain(q, k, v, n * lc, 0, 0)
    assert (got.float() - dense.float()).abs().max().item() <= bf16_limit(dense)


def test_ring_backend_matches_dense_fused_attention(dev):
    """The whole-tensor wrapper on `make_mesh(seq=4)` over one card (a
    virtual ring), against the dense fused attention's plain version: the
    same [txt | img | concept | pad] contract, computed without a ring."""
    from conceptattention_torch.parallel import make_mesh

    n, t, p, c, d = 4, 40, 230, 6, 128
    s = t + p + c + 4  # padded to a multiple of 4
    gen = torch.Generator(dev).manual_seed(7)
    q, k, v = (torch.randn(1, 2, s, d, generator=gen, device=dev) for _ in range(3))
    q, k, v = (3 * q).bfloat16(), k.bfloat16(), v.bfloat16()
    mesh = make_mesh(seq=n, devices=[dev] * n)
    fn = rr.make_ring_concept_attention_rdma(mesh, "seq", t, p, c)
    got = fn(q, k, v)
    torch.cuda.synchronize()
    want = fs.fused_concept_flash_attention_plain(q, k, v, t, p, c)
    assert got.shape == q.shape and got.device == q.device
    assert (got.float() - want.float()).abs().max().item() <= bf16_limit(want)


def test_ring_kernel_across_cards():
    """A ring of 2 across cards 0 and 1: each rank's q, state and comm
    buffers on its own card, the hops peer copies."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    devs = [torch.device("cuda", 0), torch.device("cuda", 1)]
    gen = torch.Generator(devs[0]).manual_seed(8)
    _, (qs, ks, vs) = ring_inputs(gen, 2, 1, 4, 300, 128, devs[0], chunk_offsets=True)
    qs, ks, vs = ([x.to(d) for x, d in zip(xs, devs)] for xs in (qs, ks, vs))
    kw = dict(masked=True, txt_len=50, img_len=500, concept_len=7)
    got = rr.ring_attention_rdma(qs, ks, vs, **kw)
    for d_ in devs:
        torch.cuda.synchronize(d_)
    want = rr.ring_attention_rdma_plain(qs, ks, vs, **kw)
    for g, w, d_ in zip(got, want, devs):
        assert g.device == d_
        assert (g.float() - w.float()).abs().max().item() <= bf16_limit(w)


@pytest.mark.parametrize("d,dtype", [(48, torch.bfloat16), (512, torch.bfloat16), (64, torch.float32)])
def test_ring_kernel_refuses_bad_inputs(dev, d, dtype):
    """An unsupported head dim or type raises on the card: no fallback."""
    qs = [torch.zeros(1, 2, 64, d, device=dev, dtype=dtype) for _ in range(2)]
    before = (rr.ring_attention_rdma.launches, rr.ring_attention_rdma.step_launches)
    with pytest.raises((ValueError, TypeError)):
        rr.ring_attention_rdma(qs, qs, qs)
    assert (rr.ring_attention_rdma.launches, rr.ring_attention_rdma.step_launches) == before
