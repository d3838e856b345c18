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
from conceptattention_torch.kernels import layer_norm as lnk
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


@pytest.mark.parametrize("case", ["odd_heads", "head_dim", "no_tables", "misaligned"])
def test_paired_kernel_refuses_bad_inputs(dev, case):
    """What K3 does not take raises before any launch; a q not 16-byte
    aligned (TMA, and the RoPE pre-pass's 16-byte loads) too."""
    h, d = (3, 64) if case == "odd_heads" else (2, 128) if case == "head_dim" else (2, 64)
    q = torch.zeros(1, h, 64, d, device=dev, dtype=torch.bfloat16)
    cos = sin = torch.ones(1, 64, d, device=dev)
    if case == "no_tables":
        cos = sin = None
    elif case == "misaligned":  # contiguous, 2 bytes off alignment
        q = torch.zeros(q.numel() + 1, device=dev, dtype=torch.bfloat16)[1:].view(q.shape)
    before = fs.fused_concept_flash_attention_paired.launches
    with pytest.raises(ValueError):
        fs.fused_concept_flash_attention_paired(q, q, q, cos, sin, 64, 0, 0)
    assert fs.fused_concept_flash_attention_paired.launches == before


PAIRED_CASES = [
    (2, 4, 300, 26, 200, 26, True, True),     # B=2 with per-row tables, ragged tail, pad rows
    (2, 4, 300, 26, 200, 26, True, False),
    (2, 4, 300, 26, 200, 26, False, True),
    (2, 4, 300, 26, 200, 26, False, False),   # concept rows see nothing
    (1, 4, 300, 40, 250, 5, True, True),      # two pairs, S not a multiple of 128, pad rows
    (1, 6, 300, 40, 250, 5, True, True),      # three pairs
    (2, 4, 391, 60, 300, 17, True, True),
    (1, 4, 150, 40, 80, 20, True, True),      # concepts 120..140 straddle key tile 128
    (1, 4, 150, 40, 80, 20, True, False),
    (1, 4, 150, 40, 80, 20, False, True),
    (1, 4, 150, 40, 80, 20, False, False),
    (1, 2, 1300, 30, 1200, 50, True, True),   # 11 key tiles: the 4-stage ring's phase
    (2, 6, 1300, 30, 1200, 50, False, True),  # crosses the head boundary mid-ring
]


@pytest.mark.parametrize("b,h,s,t,p,c,cross,self_attention", PAIRED_CASES)
def test_paired_kernel_matches_plain(dev, b, h, s, t, p, c, cross, self_attention):
    """K3 goes through the Hopper kernel's paired instance (one block walks
    both heads of a pair through one ring): its counter moves by one and
    K1's do not, the output holds to the plain version and to K1, and pad
    rows are exact zeros."""
    d = 64
    gen = torch.Generator(dev).manual_seed(11)
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev) for _ in range(3))
    q, k, v = (3 * q).bfloat16(), k.bfloat16(), v.bfloat16()
    cos, sin = rope_tables(gen, b, s, d, dev)
    args = (q, k, v, cos, sin, t, p, c, cross, self_attention)
    counters = (fs.fused_concept_flash_attention_paired, fs.fused_concept_flash_attention,
                fs.fused_concept_flash_attention_hopper)
    before = [fn.launches for fn in counters]
    got = fs.fused_concept_flash_attention_paired(*args)
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(counters, before)] == [1, 0, 0]
    want = fs.fused_concept_flash_attention_paired_plain(*args)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= bf16_limit(want)
    single = fs.fused_concept_flash_attention(q, k, v, t, p, c, cross, self_attention, cos, sin)
    assert (got.float() - single.float()).abs().max().item() <= bf16_limit(want)
    seen_by_nothing = t + p + (c if (cross or self_attention) else 0)
    assert torch.count_nonzero(got[:, :, seen_by_nothing:]).item() == 0


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


HOPPER_INT8_CASES = [
    # b, h, s, t, p, c, cross, self_attention, rope, zero_rows
    (1, 2, 300, 40, 250, 5, True, True, True, False),      # S not a multiple of 128, pad rows
    (1, 2, 150, 40, 80, 20, True, True, True, False),      # concepts 120..140 straddle key tile 128
    (1, 2, 150, 40, 80, 20, True, False, True, False),
    (1, 2, 150, 40, 80, 20, False, True, True, False),
    (1, 2, 150, 40, 80, 20, False, False, True, False),    # concept rows see nothing
    (2, 3, 391, 60, 300, 17, True, True, True, False),     # B=2 with per-row tables
    (1, 2, 300, 300, 0, 0, True, True, False, False),      # no tables, ragged tail
    (1, 2, 270, 40, 200, 9, True, True, False, False),     # no tables, concepts
    (1, 2, 1300, 30, 1200, 50, True, True, True, False),   # 11 key tiles: the 4-stage ring wraps
    (2, 3, 391, 60, 300, 17, True, True, True, True),      # an all-zero q row and k row
    (1, 2, 270, 40, 200, 9, True, True, False, True),      # the same without tables
]


def int8_inputs(seed, b, h, s, d, t, rope, zero_rows, dev):
    gen = torch.Generator(dev).manual_seed(seed)
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev) for _ in range(3))
    q, k, v = (3 * q).bfloat16(), k.bfloat16(), v.bfloat16()
    if zero_rows:  # one img query row scores 0 against every key; one img key row scores 0
        q[:, :, t + 7] = 0
        k[:, :, t + 11] = 0
    return q, k, v, *(rope_tables(gen, b, s, d, dev) if rope else (None, None))


@pytest.mark.parametrize("b,h,s,t,p,c,cross,self_attention,rope,zero_rows", HOPPER_INT8_CASES)
def test_hopper_int8_kernel_matches_plain(dev, b, h, s, t, p, c, cross, self_attention, rope,
                                          zero_rows):
    """K1b at head dim 128 goes through the Hopper instance: its counter and
    K1b's move by one and K1's not, the output is finite and holds to the
    plain version, and pad rows are exact zeros."""
    d = 128
    q, k, v, cos, sin = int8_inputs(13, b, h, s, d, t, rope, zero_rows, dev)
    args = (q, k, v, t, p, c, cross, self_attention, cos, sin)
    assert fs.int8_instance(d) == "hopper"
    counters = (fs.fused_concept_flash_attention_int8, fs.fused_concept_flash_attention_int8_hopper,
                fs.fused_concept_flash_attention, fs.fused_concept_flash_attention_hopper)
    before = [fn.launches for fn in counters]
    got = fs.fused_concept_flash_attention(*args, int8_qk=True)
    torch.cuda.synchronize()
    assert [fn.launches - n for fn, n in zip(counters, before)] == [1, 1, 0, 0]
    want = fs.fused_concept_flash_attention_plain(*args, int8_qk=True)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= bf16_limit(want)
    seen_by_nothing = t + p + (c if (cross or self_attention) else 0)
    assert torch.count_nonzero(got[:, :, seen_by_nothing:]).item() == 0


@pytest.mark.parametrize("rope", [True, False])
def test_int8_prepass_matches_plain_quantizer_d128(dev, rope):
    """The pre-pass that feeds the Hopper K1b: its int8 rows and f32 scales
    equal the plain quantizer's bit for bit, zero rows (scale 0) included."""
    q, k, _, cos, sin = int8_inputs(14, 2, 3, 391, 128, 60, rope, True, dev)
    got = fs.quantize_qk_rows_cuda(q, k, cos, sin)
    torch.cuda.synchronize()
    for got_part, want_part in zip(got, fs.quantize_qk_rows_plain(q, k, cos, sin)):
        assert torch.equal(got_part, want_part)
    assert got[1][:, :, 60 + 7].eq(0).all() and got[3][:, :, 60 + 11].eq(0).all()


@pytest.mark.parametrize("d", [32, 64, 128])
def test_int8_head_dims_route_to_their_instance(dev, d):
    """Head dim 128 (the flux blocks) launches the Hopper K1b; 32 and 64 keep
    the mma.sync kernel."""
    q = torch.randn(1, 1, 70, d, device=dev).bfloat16()
    counters = (fs.fused_concept_flash_attention_int8, fs.fused_concept_flash_attention_int8_hopper)
    before = [fn.launches for fn in counters]
    fs.fused_concept_flash_attention(q, q, q, 70, 0, 0, int8_qk=True)
    torch.cuda.synchronize()
    hopper = d == 128
    assert fs.int8_instance(d) == ("hopper" if hopper else "mma_sync")
    assert [fn.launches - n for fn, n in zip(counters, before)] == [1, int(hopper)]


def test_hopper_int8_kernel_raises_without_fallback(dev):
    """A head-dim-128 int8 call the Hopper kernel cannot take (q not 16-byte
    aligned for the pre-pass and TMA) raises; it is not sent to the mma.sync
    kernel or the plain version, and no counter moves. The Hopper wrapper
    refuses head dim 64."""
    d = 128
    buf = torch.zeros(70 * d + 1, device=dev, dtype=torch.bfloat16)
    q = buf[1:].view(1, 1, 70, d)  # contiguous, 2 bytes off alignment
    k = torch.zeros_like(q)
    counters = (fs.fused_concept_flash_attention_int8, fs.fused_concept_flash_attention_int8_hopper,
                fs.fused_concept_flash_attention)
    before = [fn.launches for fn in counters]
    with pytest.raises(ValueError, match="aligned"):
        fs.fused_concept_flash_attention(q, k, k, 70, 0, 0, int8_qk=True)
    with pytest.raises(ValueError, match="aligned"):
        fs.fused_concept_flash_attention_int8_hopper(q, k, k, 70, 0, 0)
    q64 = torch.zeros(1, 1, 70, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        fs.fused_concept_flash_attention_int8_hopper(q64, q64, q64, 70, 0, 0)
    assert [fn.launches for fn in counters] == before


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
        (4, 2, 3, 200, 128, 50, 300, 20, True, True),    # chunks 2 and 3 all pad rows
        (3, 1, 2, 300, 64, 40, 700, 30, False, True),    # Lc not a multiple of 128, odd ring
        # rank 3 (concept rows, cross only) reaches no key tile at step 0 (its own
        # chunk: concepts and pad) nor at step N-1 (chunk 0: txt), only at 1 and 2;
        # chunks of whole key tiles, so no tile reaches past a chunk's end
        (4, 1, 2, 128, 128, 128, 256, 100, True, False),
        (4, 1, 2, 384, 64, 384, 768, 300, True, False),  # the same with 3 key tiles a chunk
    ],
)
def test_ring_kernel_matches_plain(dev, n, b, h, lc, d, t, p, c, cross, self_attention):
    """K4 on a virtual ring of N ranks on one card against its plain version,
    and padded rows exactly zero; head dims 64 and 128 take the Hopper step
    kernel (its counter moves by one per step), 32 the mma.sync one."""
    gen = torch.Generator(dev).manual_seed(5)
    _, (qs, ks, vs) = ring_inputs(gen, n, b, h, lc, d, dev)
    kw = dict(masked=True, txt_len=t, img_len=p, concept_len=c, cross=cross,
              self_attention=self_attention)
    hopper = n if rr.ring_instance(d) == "hopper" else 0
    before = (rr.ring_attention_rdma.launches, rr.ring_attention_rdma.step_launches,
              rr.ring_attention_rdma.hopper_step_launches)
    got = rr.ring_attention_rdma(qs, ks, vs, **kw)
    torch.cuda.synchronize()
    assert (rr.ring_attention_rdma.launches, rr.ring_attention_rdma.step_launches,
            rr.ring_attention_rdma.hopper_step_launches) == (
        before[0] + 1, before[1] + n, before[2] + hopper)
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


def state_close(acc, ml, want, v):
    """The kernel's state (acc [B, H, Lc, D], ml [B, H, Lc, 2]) against the
    plain step's: the same rows empty (max -inf, sum 0, acc 0); elsewhere the
    max within 1e-4 of 1 + |max| (f32 sums in another order), the sum within
    1e-3 of itself (an approximate exp2), and acc within 2^-7 of sum x
    max|v| (each term's bf16 P may round one step apart: at most 2^-8 of
    p |v|)."""
    want_acc, want_ml = want
    m, l, wm, wl = ml[..., 0], ml[..., 1], want_ml[..., 0], want_ml[..., 1]
    empty = torch.isinf(wm)
    assert torch.equal(torch.isinf(m), empty) and bool((m[empty] < 0).all())
    assert torch.count_nonzero(l[empty]).item() == 0
    assert torch.count_nonzero(acc[empty]).item() == 0
    seen = ~empty
    assert bool(((m - wm).abs()[seen] <= 1e-4 * (1 + wm.abs()[seen])).all())
    assert bool(((l - wl).abs()[seen] <= 1e-3 * wl[seen]).all())
    tol = 2.0**-7 * wl[..., None] * v.float().abs().max()
    assert bool(((acc - want_acc).abs() <= tol).all())


@pytest.mark.parametrize(
    "n,b,h,lc,d,t,p,c,cross,self_attention,masked",
    [
        (4, 1, 2, 330, 128, 330, 660, 300, True, False, True),  # ranks that skip steps
        (4, 1, 2, 330, 64, 330, 660, 300, True, False, True),
        (3, 2, 2, 300, 64, 40, 700, 30, True, True, True),      # B=2, pad rows
        (4, 1, 3, 1089, 128, 256, 4096, 3, True, True, True),   # the flux double block's chunks
        (2, 1, 2, 200, 128, 0, 0, 0, True, True, False),         # unmasked, ragged tiles
    ],
)
def test_ring_step_state_matches_plain(dev, n, b, h, lc, d, t, p, c, cross, self_attention,
                                       masked):
    """`ring_step` launched step by step on caller buffers, each rank given
    the chunk it holds at that step: after each of steps 0..N-2 its f32
    running state holds to `ring_step_plain`'s (so a fault in the
    fragment-to-state layout shows before the final division hides it), and
    the output of step N-1 to the plain output."""
    gen = torch.Generator(dev).manual_seed(13)
    _, (qs, ks, vs) = ring_inputs(gen, n, b, h, lc, d, dev)
    kw = dict(masked=masked, txt_len=t, img_len=p, concept_len=c, cross=cross,
              self_attention=self_attention)
    accs = [torch.empty(b, h, lc, d, device=dev) for _ in range(n)]
    mls = [torch.empty(b, h, lc, 2, device=dev) for _ in range(n)]
    outs = [torch.empty_like(q) for q in qs]
    plain = [None] * n
    hopper = n if rr.ring_instance(d) == "hopper" else 0
    before = (rr.ring_attention_rdma.step_launches, rr.ring_attention_rdma.hopper_step_launches)
    for step in range(n):
        held = [(r - step) % n for r in range(n)]
        rr.ring_step(qs, [ks[i] for i in held], [vs[i] for i in held], accs, mls, outs,
                     list(range(n)), n, step, **kw)
        torch.cuda.synchronize()
        for my in range(n):
            plain[my] = rr.ring_step_plain(qs[my], ks[held[my]], vs[held[my]], plain[my], my, step,
                                           n, **kw)
            if step < n - 1:
                state_close(accs[my], mls[my], plain[my], vs[held[my]])
    assert (rr.ring_attention_rdma.step_launches,
            rr.ring_attention_rdma.hopper_step_launches) == (before[0] + n, before[1] + hopper)
    got, want = torch.cat(outs, dim=2), torch.cat(plain, dim=2)
    assert (got.float() - want.float()).abs().max().item() <= bf16_limit(want)


def test_hopper_ring_kernel_raises_without_fallback(dev):
    """A head-dim-128 ring the Hopper step kernel cannot take (a shard not
    16-byte aligned for TMA) raises; it is not sent to the mma.sync kernel,
    and no counter moves."""
    buf = torch.zeros(64 * 128 * 2 + 1, device=dev, dtype=torch.bfloat16)
    bad = buf[1:].view(1, 2, 64, 128)  # contiguous, 2 bytes off alignment
    qs = [bad, torch.zeros(1, 2, 64, 128, device=dev, dtype=torch.bfloat16)]
    counters = (rr.ring_attention_rdma.launches, rr.ring_attention_rdma.step_launches,
                rr.ring_attention_rdma.hopper_step_launches)
    with pytest.raises(ValueError, match="aligned"):
        rr.ring_attention_rdma(qs, qs, qs)
    assert (rr.ring_attention_rdma.launches, rr.ring_attention_rdma.step_launches,
            rr.ring_attention_rdma.hopper_step_launches) == counters



def without_key_tile(args, start):
    """The plain attention with the 64 keys [start, start + 64) taken out of
    the txt|img segment (a kernel that skips one key tile), on the rows kept."""
    q, k, v, t, p, c, cross, self_attention, cos, sin = args
    keep = torch.cat([torch.arange(start), torch.arange(start + 64, q.shape[2])]).to(q.device)
    t, p = (t - 64, p) if start < t else (t, p - 64)
    return keep, fs.fused_concept_flash_attention_plain(
        q[:, :, keep], k[:, :, keep], v[:, :, keep], t, p, c, cross, self_attention,
        cos[:, keep].contiguous(), sin[:, keep].contiguous())


@pytest.mark.parametrize(
    "b,s,t,p,c",
    [
        (1, 4611, 512, 4096, 3),   # flux-dev double block: 512 txt + 4096 img + 3 concepts
        (1, 4608, 4608, 0, 0),     # flux-dev single block
        (4, 4355, 256, 4096, 3),   # flux-schnell double block in encode_images at batch 4
        (2, 4352, 4352, 0, 0),     # flux-schnell single block, two coalesced served requests
        (1, 4352, 256, 4096, 0),   # flux-schnell double block without concepts (true CFG)
    ],
    ids=["dev-double", "dev-single", "schnell-double-b4", "schnell-single-b2",
         "schnell-double-no-concepts"],
)
def test_hopper_flash_kernel_at_new_pipeline_shapes(dev, b, s, t, p, c):
    """K1 at the sequence lengths and batch the new entry points give it
    (four of the 24 heads), with RoPE tables and concept rows, held to the
    plain version; the plain version without one img key tile breaks the
    limit."""
    gen = torch.Generator(dev).manual_seed(11)
    q, k, v = (torch.randn(b, 4, s, 128, generator=gen, device=dev) for _ in range(3))
    args = ((3 * q).bfloat16(), k.bfloat16(), v.bfloat16(), t, p, c, True, True,
            *rope_tables(gen, b, s, 128, dev))
    got = fs.fused_concept_flash_attention(*args)
    torch.cuda.synchronize()
    want = fs.fused_concept_flash_attention_plain(*args)
    limit = bf16_limit(want)
    assert (got.float() - want.float()).abs().max().item() <= limit
    keep, control = without_key_tile(args, min(t, s - 64) if p else 64 * 40)
    assert (control.float() - want[:, :, keep].float()).abs().max().item() > limit


@pytest.mark.parametrize(
    "res,cin,cout",
    [(1024, 128, 128), (512, 128, 256), (512, 256, 256), (256, 256, 512), (256, 512, 512),
     (128, 512, 512)],
)
def test_conv_kernel_at_encoder_shapes(dev, res, cin, cout):
    """K2 (its Hopper instance) at every 3x3 conv shape of the 1024^2 NHWC
    encoder that the gate admits, held to the plain version; a weight with
    one 32-deep K slice zeroed breaks the limit."""
    gen = torch.Generator(dev).manual_seed(5)
    x = torch.randn(1, res, res, cin, generator=gen, device=dev).bfloat16()
    w = (torch.randn(3, 3, cin, cout, generator=gen, device=dev) / (9 * cin) ** 0.5).bfloat16()
    bias = (0.1 * torch.randn(cout, generator=gen, device=dev)).bfloat16()
    assert conv.conv3x3_instance(x.dtype, cin, cout) == "hopper"
    assert conv.use_conv3x3_kernel(x, cin, cout)
    got = conv.conv3x3_same(x, w, bias)
    torch.cuda.synchronize()
    want = conv.conv3x3_same_plain(x, w, bias)
    limit = bf16_limit(want)
    assert (got.float() - want.float()).abs().max().item() <= limit
    dropped = w.clone()
    dropped[0, 0, :32] = 0
    assert (conv.conv3x3_same_plain(x, dropped, bias).float() - want.float()).abs().max().item() > limit


@pytest.mark.parametrize("cross,self_attention",
                         [(True, True), (True, False), (False, True), (False, False)],
                         ids=["cross+self", "cross", "self", "neither"])
@pytest.mark.parametrize("b", [1, 4])
def test_hopper_flash_kernel_at_eval_shape(dev, b, cross, self_attention):
    """K1 at the segmentation harness's double block: 512^2 input (256 txt +
    1024 img rows) with 6 concepts, all 24 heads, at batch 1 and 4 (the
    harness's --image_batch 4), in the four cross / self modes; the joint
    and concept rows each against their own limit. Each concept key points
    along its query (unrotated), so its own score competes with the image
    keys' and both concept terms carry weight. Controls: the plain version
    with one img key tile dropped (joint rows) and with the concept mode
    flipped (concept rows) break their limits."""
    t, p, c = 256, 1024, 6
    s = t + p + c
    gen = torch.Generator(dev).manual_seed(12)
    q, k, v = (torch.randn(b, 24, s, 128, generator=gen, device=dev) for _ in range(3))
    qc = q[:, :, t + p:]
    k[:, :, t + p:] = 4.0 * qc / qc.norm(dim=-1, keepdim=True)
    cos, sin = rope_tables(gen, b, s, 128, dev)
    cos[:, t + p:], sin[:, t + p:] = 1.0, 0.0
    args = ((3 * q).bfloat16(), k.bfloat16(), v.bfloat16(), t, p, c, cross, self_attention,
            cos, sin)
    got = fs.fused_concept_flash_attention(*args)
    torch.cuda.synchronize()
    want = fs.fused_concept_flash_attention_plain(*args)
    joint, concept = slice(0, t + p), slice(t + p, s)
    for rows in (joint, concept):
        err = (got[:, :, rows].float() - want[:, :, rows].float()).abs().max().item()
        assert err <= bf16_limit(want[:, :, rows])
    flipped = fs.fused_concept_flash_attention_plain(*args[:7], not self_attention, cos, sin)
    control = (flipped[:, :, concept].float() - want[:, :, concept].float()).abs().max().item()
    assert control > bf16_limit(want[:, :, concept])
    keep, dropped = without_key_tile(args, t + 64 * 8)
    control = (dropped[:, :, :t + p - 64].float() - want[:, :, keep[:t + p - 64]].float())
    assert control.abs().max().item() > bf16_limit(want[:, :, joint])


def kernel_counts():
    """Every launch counter of the kernel wrappers."""
    return (fs.fused_concept_flash_attention.launches,
            fs.fused_concept_flash_attention_hopper.launches,
            fs.fused_concept_flash_attention_int8.launches,
            fs.fused_concept_flash_attention_int8_hopper.launches,
            fs.fused_concept_flash_attention_paired.launches, conv.conv3x3_same.launches,
            conv.conv3x3_same_generic.launches, conv.conv3x3_same_hopper.launches,
            rr.ring_attention_rdma.launches, rr.ring_attention_rdma.step_launches,
            rr.ring_attention_rdma.hopper_step_launches, lnk.layer_norm.launches,
            lnk.qk_layer_norm.launches)


def guarded_call(name, dev, requires_grad):
    """One call of the kernel entry `name` on card inputs of its contract,
    q (or x) requiring grad when asked."""
    gen = torch.Generator(dev).manual_seed(20)

    def attn(d, h=2, s=130):
        q, k, v = (torch.randn(1, h, s, d, generator=gen, device=dev).bfloat16() for _ in range(3))
        return (q.requires_grad_(requires_grad), k, v, *rope_tables(gen, 1, s, d, dev))

    if name.startswith("fused_concept_flash_attention"):
        d = {"fused_concept_flash_attention": 32, "fused_concept_flash_attention_hopper": 128,
             "fused_concept_flash_attention_int8": 64,
             "fused_concept_flash_attention_int8_hopper": 128,
             "fused_concept_flash_attention_paired": 64}[name]
        q, k, v, cos, sin = attn(d)
        if name.endswith("paired"):
            return fs.fused_concept_flash_attention_paired(q, k, v, cos, sin, 40, 80, 5)
        return getattr(fs, name)(q, k, v, 40, 80, 5, rope_cos=cos, rope_sin=sin)
    if name.startswith("conv3x3"):
        dtype, cin = (torch.float32, 32) if name.endswith("generic") else (torch.bfloat16, 64)
        x = torch.randn(1, 16, 16, cin, generator=gen, device=dev).to(dtype)
        w = (torch.randn(3, 3, cin, 64, generator=gen, device=dev) * 0.05).to(dtype)
        return getattr(conv, name)(x.requires_grad_(requires_grad), w,
                                   torch.zeros(64, device=dev, dtype=dtype))
    if name == "layer_norm":
        return lnk.layer_norm(torch.randn(2, 40, 3072, generator=gen, device=dev).bfloat16()
                              .requires_grad_(requires_grad))
    if name == "qk_layer_norm":
        qkv = torch.randn(2, 40, 3 * 4 * 64, generator=gen, device=dev).bfloat16()
        return lnk.qk_layer_norm(qkv.requires_grad_(requires_grad), 4)
    q, k, v, _, _ = attn(128, s=128)
    if name == "ring_attention_rdma":
        return rr.ring_attention_rdma(*([c.contiguous() for c in x.chunk(2, 2)] for x in (q, k, v)))
    out = torch.empty(q.shape, dtype=torch.bfloat16, device=dev)
    return rr.ring_step([q], [k], [v], [None], [None], [out], [0], 1, 0)


GUARDED = ["fused_concept_flash_attention", "fused_concept_flash_attention_hopper",
           "fused_concept_flash_attention_int8", "fused_concept_flash_attention_int8_hopper",
           "fused_concept_flash_attention_paired", "conv3x3_same", "conv3x3_same_generic",
           "conv3x3_same_hopper", "ring_attention_rdma", "ring_step", "layer_norm",
           "qk_layer_norm"]


@pytest.mark.parametrize("name", GUARDED)
def test_kernel_entries_refuse_autograd(dev, name):
    """An input that requires grad, with autograd on, makes every kernel
    entry raise before anything launches (its output would carry no
    gradient; no quiet switch to the plain version); the same call under
    no_grad launches and counts."""
    before = kernel_counts()
    with pytest.raises(RuntimeError, match=f"{name} has no backward"):
        guarded_call(name, dev, True)
    torch.cuda.synchronize()
    assert kernel_counts() == before
    with torch.no_grad():
        guarded_call(name, dev, True)
    torch.cuda.synchronize()
    assert kernel_counts() != before


@pytest.mark.parametrize("s,t,p,c", [(4355, 256, 4096, 3), (4352, 4352, 0, 0)],
                         ids=["double", "single"])
def test_hopper_flash_kernel_at_a_tensor_parallel_rank(dev, s, t, p, c):
    """K1 as one rank of tensor-parallel serving at model=2 runs it: 12 of
    flux-schnell's 24 heads at 1024² (the double block with its concept
    rows, the single block as one segment), held to the plain version; the
    plain version without one img key tile breaks the limit."""
    gen = torch.Generator(dev).manual_seed(15)
    q, k, v = (torch.randn(1, 12, s, 128, generator=gen, device=dev) for _ in range(3))
    args = ((3 * q).bfloat16(), k.bfloat16(), v.bfloat16(), t, p, c, True, True,
            *rope_tables(gen, 1, s, 128, dev))
    before = fs.fused_concept_flash_attention_hopper.launches
    got = fs.fused_concept_flash_attention(*args)
    torch.cuda.synchronize()
    assert fs.fused_concept_flash_attention_hopper.launches == before + 1
    want = fs.fused_concept_flash_attention_plain(*args)
    limit = bf16_limit(want)
    assert (got.float() - want.float()).abs().max().item() <= limit
    keep, control = without_key_tile(args, t if p else 64 * 40)
    assert (control.float() - want[:, :, keep].float()).abs().max().item() > limit


def test_ring_kernel_on_batch_and_head_sliced_rings(dev):
    """The dp x sp x tp ring on `make_mesh(data=2, seq=2, model=2)` of one
    card: each (data, model) slice runs its own ring of 2 over its batch row
    and half of the heads (one `ring_attention_rdma` call, 2 Hopper step
    launches, per slice), against the dense fused attention's plain version
    on the whole tensor."""
    from conceptattention_torch.parallel import make_mesh

    t, p, c, d = 40, 230, 6, 128
    s = t + p + c + 2  # padded to a multiple of 2
    gen = torch.Generator(dev).manual_seed(16)
    q, k, v = (torch.randn(2, 4, s, d, generator=gen, device=dev) for _ in range(3))
    q, k, v = (3 * q).bfloat16(), k.bfloat16(), v.bfloat16()
    mesh = make_mesh(data=2, seq=2, model=2, devices=[dev] * 8)
    fn = rr.make_ring_concept_attention_rdma(mesh, "seq", t, p, c, batch_axis="data",
                                             head_axis="model")
    before = (rr.ring_attention_rdma.launches, rr.ring_attention_rdma.hopper_step_launches)
    got = fn(q, k, v)
    torch.cuda.synchronize()
    assert (rr.ring_attention_rdma.launches - before[0],
            rr.ring_attention_rdma.hopper_step_launches - before[1]) == (4, 8)
    want = fs.fused_concept_flash_attention_plain(q, k, v, t, p, c)
    assert got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= bf16_limit(want)


# K1 at head dim 128 through each compiled instance (FLASH_D128_INSTANCES):
# B1 H24 at flux-schnell's double block at 1024² with 3 concepts, its single
# block (no concept rows), the eval path's double block at 512² with 6
# concepts, the double block with 5 pad rows past its concepts (a ragged
# last query tile), the eval double block at B4, and a HunyuanVideo-like
# double block (32 text rows, 4 concept rows) cut to 3108 rows: (B, S, txt,
# img, concepts).
INSTANCE_SHAPES = {"double": (1, 4355, 256, 4096, 3), "single": (1, 4352, 4352, 0, 0),
                   "eval": (1, 1286, 256, 1024, 6), "padded": (1, 4360, 256, 4096, 3),
                   "eval_b4": (4, 1286, 256, 1024, 6), "hunyuan_like": (1, 3108, 32, 3072, 4)}


@pytest.mark.parametrize("shape", list(INSTANCE_SHAPES))
@pytest.mark.parametrize("instance", range(len(fs.FLASH_D128_INSTANCES)))
def test_hopper_flash_instance_matches_plain(dev, instance, shape):
    """Each D=128 instance holds to the plain version on the joint and the
    concept rows, each against its own limit; pad rows are exact zeros; the
    instance's own counter moves by one and no other instance's does."""
    b, s, t, p, c = INSTANCE_SHAPES[shape]
    gen = torch.Generator(dev).manual_seed(31)
    q, k, v = (torch.randn(b, 24, s, 128, generator=gen, device=dev) for _ in range(3))
    args = ((3 * q).bfloat16(), k.bfloat16(), v.bfloat16(), t, p, c, True, True,
            *rope_tables(gen, b, s, 128, dev))
    before = list(fs.fused_concept_flash_attention_hopper.instance_launches)
    got = fs.fused_concept_flash_attention_hopper(*args, instance=instance)
    torch.cuda.synchronize()
    want_counts = list(before)
    want_counts[instance] += 1
    assert fs.fused_concept_flash_attention_hopper.instance_launches == want_counts
    want = fs.fused_concept_flash_attention_plain(*args)
    for rows in (slice(0, t + p), slice(t + p, t + p + c)):
        if rows.stop > rows.start:
            err = (got[:, :, rows].float() - want[:, :, rows].float()).abs().max().item()
            assert err <= bf16_limit(want[:, :, rows])
    assert torch.count_nonzero(got[:, :, t + p + c:]).item() == 0


def plain_rows(args, rows):
    """`fused_concept_flash_attention_plain` at query `rows` alone (every
    head), with its rounding points: its [S, S] scores do not fit at S of
    67k. -> [B, H, len(rows), D]."""
    q, k, v, t, p, c, cross, self_attention, cos, sin = args
    qr, kr = fs.rope_qk_rows_plain(q, k, cos, sin)
    kj = torch.arange(q.shape[2], device=q.device)[None]
    qi = rows[:, None]
    concept_keys = torch.zeros_like(kj, dtype=torch.bool)
    if cross:
        concept_keys = concept_keys | ((kj >= t) & (kj < t + p))
    if self_attention:
        concept_keys = concept_keys | ((kj >= t + p) & (kj < t + p + c))
    allowed = ((qi < t + p) & (kj < t + p)) | ((qi >= t + p) & (qi < t + p + c) & concept_keys)
    scores = qr[:, :, rows].float() @ kr.float().transpose(-1, -2)
    scores = scores.masked_fill(~allowed, fs.NEG_INF)
    pm = torch.exp2(scores - scores.amax(dim=-1, keepdim=True)).masked_fill(~allowed, 0.0)
    l = pm.sum(dim=-1, keepdim=True)
    acc = pm.to(v.dtype).float() @ v.float()
    return (acc / torch.where(l == 0, torch.ones_like(l), l)).to(v.dtype)


# The default D=128 instance's calls: flux's double and single blocks
# (B1 H24), and HunyuanVideo's double (32 text rows, 4 concepts) and single
# blocks at their full 67k rows on heads 0-1: (H, S, txt, img, concepts).
DEFAULT_SHAPES = {"flux_double": (24, 4355, 256, 4096, 3),
                  "flux_single": (24, 4352, 4352, 0, 0),
                  "hunyuan_double": (2, 67356, 32, 67320, 4),
                  "hunyuan_single": (2, 67352, 67352, 0, 0)}


@pytest.mark.parametrize("shape", list(DEFAULT_SHAPES))
def test_default_d128_instance_takes_the_call(dev, shape):
    """Without a tuned entry K1's entry point launches the default instance
    (the register-reallocating overlap, instance 3): its slot of
    `instance_launches` moves by one a call and no other does, twice. Its
    output holds to the plain version at the first 512 rows (the text rows
    of a double block), 512 rows from the middle of the joint rows and the
    concept rows, each against its own limit."""
    h, s, t, p, c = DEFAULT_SHAPES[shape]
    default = fs.D128_DEFAULT_INSTANCE
    assert fs.FLASH_D128_INSTANCES[default] == "<128, 128, 192, 2, overlap wide, 1>"
    saved, flag = dict(fs._TUNED_TILES), fs._tile_cache_loaded
    fs._TUNED_TILES.clear()
    fs._tile_cache_loaded = True
    try:
        gen = torch.Generator(dev).manual_seed(34)
        q, k, v = (torch.randn(1, h, s, 128, generator=gen, device=dev) for _ in range(3))
        args = ((3 * q).bfloat16(), k.bfloat16(), v.bfloat16(), t, p, c, True, True,
                *rope_tables(gen, 1, s, 128, dev))
        del q, k, v
        for _ in range(2):
            before = list(fs.fused_concept_flash_attention_hopper.instance_launches)
            got = fs.fused_concept_flash_attention(*args)
            torch.cuda.synchronize()
            after = fs.fused_concept_flash_attention_hopper.instance_launches
            assert [a - b for a, b in zip(after, before)] == [
                int(i == default) for i in range(len(fs.FLASH_D128_INSTANCES))]
        mid = (t + p) // 2
        for rows in (torch.arange(0, min(t, 512)), torch.arange(mid, mid + 512),
                     torch.arange(t + p, s)):
            if len(rows):
                rows = rows.to(dev)
                want = plain_rows(args, rows)
                err = (got[:, :, rows].float() - want.float()).abs().max().item()
                assert err <= bf16_limit(want)
    finally:
        fs._TUNED_TILES.clear()
        fs._TUNED_TILES.update(saved)
        fs._tile_cache_loaded = flag


@pytest.mark.parametrize("d,instance", [(128, len(fs.FLASH_D128_INSTANCES)), (128, -1),
                                        (64, 1), (512, 1)])
def test_hopper_flash_instance_outside_the_compiled_set_raises(dev, d, instance):
    """An instance index the head dim does not have raises ValueError before
    any launch, and the C entry refuses it too (CUDA error, nothing runs)."""
    gen = torch.Generator(dev).manual_seed(32)
    q, k, v = (torch.randn(1, 2, 130, d, generator=gen, device=dev).bfloat16() for _ in range(3))
    before = kernel_counts(), list(fs.fused_concept_flash_attention_hopper.instance_launches)
    with pytest.raises(ValueError, match="instances"):
        fs.fused_concept_flash_attention_hopper(q, k, v, 40, 80, 5, instance=instance)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fs._launch_sm90("ca_flash_saliency_sm90_bf16_instance", q, k, v, 40, 80, 5, True, True,
                        None, None, instance)
    torch.cuda.synchronize()
    assert (kernel_counts(), fs.fused_concept_flash_attention_hopper.instance_launches) == before


def test_tuned_overlay_picks_the_instance(dev):
    """A call of the workload the overlay names (head dim, S, B x H, the
    segments and the mask mode) launches that instance; a call of another
    S, or of the same S with other segments, launches the default one."""
    from conceptattention_torch.kernels.autotune import register_tuned_tiles

    saved, flag = dict(fs._TUNED_TILES), fs._tile_cache_loaded
    fs._tile_cache_loaded = True
    try:
        register_tuned_tiles(300, 2, 128, 2, segments=(40, 250, 5))
        gen = torch.Generator(dev).manual_seed(33)
        default = fs.D128_DEFAULT_INSTANCE
        for s, segments, want in ((300, (40, 250, 5), 2), (310, (40, 250, 5), default),
                                  (300, (300, 0, 0), default)):
            q, k, v = (torch.randn(1, 2, s, 128, generator=gen, device=dev).bfloat16()
                       for _ in range(3))
            args = (q, k, v, *segments, True, True, *rope_tables(gen, 1, s, 128, dev))
            before = list(fs.fused_concept_flash_attention_hopper.instance_launches)
            got = fs.fused_concept_flash_attention(*args)
            torch.cuda.synchronize()
            after = fs.fused_concept_flash_attention_hopper.instance_launches
            assert [a - b for a, b in zip(after, before)] == [
                int(i == want) for i in range(len(fs.FLASH_D128_INSTANCES))]
            want_out = fs.fused_concept_flash_attention_plain(*args)
            assert (got.float() - want_out.float()).abs().max().item() <= bf16_limit(want_out)
    finally:
        fs._TUNED_TILES.clear()
        fs._TUNED_TILES.update(saved)
        fs._tile_cache_loaded = flag


def small_flux_forward_inputs(dev, seed, size=512):
    """flux-schnell at full width cut to 2 double and 2 single blocks (bf16,
    random weights), and keyword inputs of one `size`² image with 256 txt
    rows and 3 concepts."""
    import dataclasses

    from conceptattention_torch.config import configs
    from conceptattention_torch.models.flux.params import init_flux_params
    from conceptattention_torch.ops.packing import make_img_ids

    cfg = dataclasses.replace(configs["flux-schnell"].params, depth=2, depth_single_blocks=2)
    params = init_flux_params(torch.Generator(dev).manual_seed(30), cfg, torch.bfloat16)
    gen = torch.Generator(dev).manual_seed(seed)
    grid, t, c = size // 16, 256, 3

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).bfloat16()

    inputs = dict(img=randn(1, grid * grid, cfg.in_channels),
                  img_ids=make_img_ids(grid, grid, 1, device=dev),
                  txt=randn(1, t, cfg.context_in_dim),
                  txt_ids=torch.zeros(1, t, 3, device=dev),
                  timesteps=torch.full((1,), 0.25 + 0.5 * (seed % 2), device=dev),
                  y=randn(1, cfg.vec_in_dim), concepts=randn(1, c, cfg.context_in_dim),
                  concept_ids=torch.zeros(1, c, 3, device=dev),
                  concept_vec=torch.zeros(1, cfg.vec_in_dim, device=dev, dtype=torch.bfloat16))
    return cfg, params, inputs


def test_graphed_forward_replay_equals_eager(dev):
    """make_jitted_forward on the card captures one CUDA graph and replays
    it: pred and every saliency map equal the eager flux_forward bit for
    bit, on the inputs it captured with and on new ones; an earlier output
    is not overwritten by a later replay."""
    from conceptattention_torch.models.flux.dit import flux_forward, make_jitted_forward

    cfg, params, inputs = small_flux_forward_inputs(dev, 1)
    _, _, other = small_flux_forward_inputs(dev, 2)
    fwd = make_jitted_forward(cfg)
    with torch.no_grad():
        eager = [flux_forward(params, cfg, **x) for x in (inputs, other)]
    got = [fwd(params, **x) for x in (inputs, other)]
    torch.cuda.synchronize()
    assert len(fwd.graphs) == 1
    for (gp, gs), (ep, es) in zip(got, eager):
        assert torch.equal(gp, ep)
        assert gs.keys() == es.keys() and all(torch.equal(gs[k], es[k]) for k in es)
    assert not torch.equal(got[0][0], got[1][0])


def test_graphed_forward_replay_moves_launch_counts(dev):
    """A replay adds the launches its graph holds to kernels.launch_counts,
    the same as an eager forward's: one K1 launch a block, all of them
    the default instance at head dim 128."""
    from conceptattention_torch.kernels import launch_counts
    from conceptattention_torch.models.flux.dit import flux_forward, make_jitted_forward

    cfg, params, inputs = small_flux_forward_inputs(dev, 3)
    fwd = make_jitted_forward(cfg)
    fwd(params, **inputs)
    (replay,) = fwd.graphs.values()

    def delta(run):
        before = launch_counts()
        run()
        torch.cuda.synchronize()
        return {k: v - before[k] for k, v in launch_counts().items()}

    with torch.no_grad():
        eager = delta(lambda: flux_forward(params, cfg, **inputs))
    replayed = delta(lambda: fwd(params, **inputs))
    blocks = cfg.depth + cfg.depth_single_blocks
    default = fs.D128_DEFAULT_INSTANCE
    taken = f"flash_saliency (Hopper D=128 instance {default} {fs.FLASH_D128_INSTANCES[default]})"
    assert replayed == eager == replay.launches
    assert replayed["flash_saliency"] == replayed[taken] == blocks


def test_device_trace_sees_the_card_after_graph_replays(dev, tmp_path):
    """torch.profiler sessions after CUDA graphs were captured and replayed
    under earlier sessions each record the card's kernels: a graph and a
    traced replay, a second graph and its traced replay, then an eager
    forward in a third session (the order in which such a session once
    recorded nothing). `device_trace` raises on an empty card trace."""
    from conceptattention_torch.models.flux.dit import flux_forward, make_jitted_forward
    from conceptattention_torch.utils.profiling import device_trace, kernel_events

    cfg, params, inputs = small_flux_forward_inputs(dev, 4)

    def traced(run, session):
        log_dir = str(tmp_path / f"session{session}")
        with torch.no_grad(), device_trace(log_dir):
            run()
            torch.cuda.synchronize()
        return kernel_events(f"{log_dir}/trace.json")

    graphs = []
    for session in range(2):
        graphs.append(make_jitted_forward(cfg))
        graphs[-1](params, **inputs)  # the capture, outside any session
        assert traced(lambda: graphs[-1](params, **inputs), session) > 0
    assert traced(lambda: flux_forward(params, cfg, **inputs), 2) > 0


def bf16_steps(got, want, magnitude):
    """|got - want| in bf16 steps at max(magnitude, 2**-6). The normalised
    rows have unit scale; below 2**-6 x - mean cancels, and a move of the
    f32 mean by one step is already more than a bf16 step of the element."""
    m = torch.clamp(magnitude.float().abs(), min=2.0**-6)
    return (got.float() - want.float()).abs() / torch.exp2(torch.floor(torch.log2(m)) - 7)


def unbiased_ln(x, w, b, eps):
    """A changed arithmetic, the control: the variance over D - 1."""
    xf = x.float()
    out = (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(xf.var(-1, keepdim=True) + eps)
    return (out * w.float() + b.float()).to(x.dtype)


def assert_rounding_apart(got, want, magnitude, control):
    """The kernel equals the plain version but where the f32 sum order moves
    a value across a bf16 rounding boundary: at most 2 bf16 steps, on under
    1% of the elements. The control, a changed arithmetic, moves more than
    1% of them."""
    assert got.shape == want.shape and got.dtype == want.dtype == torch.bfloat16
    assert bf16_steps(got, want, magnitude).max().item() <= 2
    assert (got != want).float().mean().item() < 0.01
    assert (control != want).float().mean().item() > 0.01


@pytest.mark.parametrize("b,l,d,modulated", [
    (2, 17550, 3072, True),   # the video LayerNormZero of CogVideoX-5b
    (2, 226, 3072, True),     # its text and concept streams
    (2, 17550, 3072, False),  # norm_final
    (2, 4003, 1920, True),    # the 2B model's width; 4003 rows fill no whole block
    (3, 77, 64, False),       # one head's width, 4 threads a row
])
def test_layer_norm_kernel_matches_plain(dev, b, l, d, modulated):
    """LayerNormZero (affine, eps 1e-5, per-batch scale and shift) and the
    plain affine LayerNorm against the plain version on the card; the
    control drops the bf16 rounding between the affine and the modulation
    (or, unmodulated, takes the unbiased variance)."""
    gen = torch.Generator(dev).manual_seed(21)

    def draw(*shape, loc=0.0, std=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * std + loc).bfloat16()

    x = draw(b, l, d, loc=0.3, std=2.0)
    w, bias = draw(d, loc=1.0, std=0.1), draw(d, std=0.1)
    scale, shift = (draw(b, 6 * d, std=0.5).chunk(6, -1)[1], draw(b, d, std=0.5)) if modulated \
        else (None, None)
    before = lnk.layer_norm.launches
    got = lnk.layer_norm(x, w, bias, 1e-5, scale=scale, shift=shift)
    torch.cuda.synchronize()
    assert lnk.layer_norm.launches == before + 1
    normed = lnk.layer_norm_plain(x, w, bias, 1e-5)
    want = lnk.layer_norm_plain(x, w, bias, 1e-5, scale, shift)
    if modulated:
        factor = 1 + scale[:, None].float()
        magnitude = torch.maximum(want.float().abs(), (normed.float() * factor).abs())
        xf = x.float()
        t = (xf - xf.mean(-1, keepdim=True)) * torch.rsqrt(xf.var(-1, correction=0, keepdim=True) + 1e-5)
        control = ((t * w.float() + bias.float()) * factor + shift[:, None].float()).bfloat16()
    else:
        magnitude, control = want, unbiased_ln(x, w, bias, 1e-5)
    assert_rounding_apart(got, want, magnitude, control)


@pytest.mark.parametrize("b,l,h", [(2, 17550, 48), (2, 226, 48), (1, 1001, 30)],
                         ids=["video", "text", "2b-heads"])
def test_qk_layer_norm_kernel_matches_plain(dev, b, l, h):
    """The per-head q and k norms (eps 1e-6, affine) read through the qkv
    GEMM output's strides and written as [B, H, L, 64], against the plain
    version; the control takes the unbiased variance."""
    gen = torch.Generator(dev).manual_seed(22)
    qkv = (torch.randn(b, l, 3 * h * 64, generator=gen, device=dev) * 1.5 - 0.2).bfloat16()
    params = [(torch.randn(64, generator=gen, device=dev) * 0.1 + (1.0 if i % 2 == 0 else 0.0))
              .bfloat16() for i in range(4)]
    before = lnk.qk_layer_norm.launches
    q, k = lnk.qk_layer_norm(qkv, h, *params, eps=1e-6)
    torch.cuda.synchronize()
    assert lnk.qk_layer_norm.launches == before + 1
    assert q.is_contiguous() and k.is_contiguous()
    want_q, want_k = lnk.qk_layer_norm_plain(qkv, h, *params, eps=1e-6)
    heads = qkv.reshape(b, l, 3, h, 64).permute(2, 0, 3, 1, 4)
    for got, want, x, (w, bias) in ((q, want_q, heads[0], params[:2]),
                                    (k, want_k, heads[1], params[2:])):
        assert_rounding_apart(got, want, want, unbiased_ln(x, w, bias, 1e-6))


def test_layer_norm_kernel_refuses_what_it_cannot_take(dev):
    """A width not a multiple of 8 or above 3072, a non-bf16 input or
    parameter, and an input that requires grad raise before anything
    launches: no fallback."""
    before = kernel_counts()
    x = torch.randn(2, 16, 64, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        lnk.layer_norm(x[..., :60].bfloat16())
    with pytest.raises(ValueError, match="at most 3072"):
        lnk.layer_norm(torch.randn(2, 16, 3080, device=dev).bfloat16())
    with pytest.raises(ValueError, match="multiple of 8"):
        lnk.qk_layer_norm(torch.randn(2, 16, 3 * 2 * 60, device=dev).bfloat16(), 2)
    with pytest.raises(TypeError, match="takes bf16"):
        lnk.layer_norm(x)
    with pytest.raises(TypeError, match="takes bf16"):
        lnk.qk_layer_norm(torch.randn(2, 16, 3 * 2 * 64, device=dev).half(), 2)
    with pytest.raises(TypeError, match="bf16 parameters"):
        lnk.layer_norm(x.bfloat16(), torch.ones(64, device=dev))
    with pytest.raises(RuntimeError, match="layer_norm has no backward"):
        lnk.layer_norm(x.bfloat16().requires_grad_(True))
    torch.cuda.synchronize()
    assert kernel_counts() == before
