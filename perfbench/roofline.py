"""Operations and bytes from shapes, and the peaks they are held against.

A count is of the work the model's shapes need, whatever kernel does it:
every matmul, attention product and convolution, at 2 operations a
multiply-add. Attention counts only the unmasked (query, key) pairs of the
concept-attention contract: [text; image] queries over [text; image] keys,
concept queries over [concept; image] keys. A roofline bound is the larger
of the operations at the compute peak and the bytes at the HBM rate, each
input read once and each output written once.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 outside
them (the program runs its float32 convolutions with TF32 off), 3.35 TB/s.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    return max(flops / peak, nbytes / HBM_BYTES_PER_S)


# ---------------------------------------------------------------- attention


def concept_pairs(t: int, p: int, c: int) -> int:
    """Unmasked (query, key) pairs of one head of the joint concept attention."""
    return (t + p) ** 2 + c * (c + p)


def attention_flops(b: int, h: int, d: int, pairs: int) -> float:
    """Q K^T and P V over `pairs` pairs of each of b x h heads."""
    return 4.0 * b * h * d * pairs


def attention_bound_s(b: int, h: int, d: int, rows: int, pairs: int, elem: int = 2) -> float:
    """One attention launch: q, k, v and the output of `rows` rows, bf16."""
    return bound_s(attention_flops(b, h, d, pairs), 4.0 * b * h * rows * d * elem)


# ---------------------------------------------------------------- Flux DiT


def flux_forward_flops(cfg: Dict, b: int, t: int, p: int, c: int,
                       stop_after_double: bool = False) -> Dict[str, float]:
    """One Flux forward of b rows with t text, p image and c concept tokens:
    {"linear", "attention", "maps"} operations. `cfg`: hidden, mlp_hidden,
    in_channels, context_in_dim, vec_in_dim, depth, depth_single."""
    d, m = cfg["hidden"], cfg["mlp_hidden"]
    n_cond = 2 if c else 1  # the concept stream's conditioning vector is its own
    lin = (p * cfg["in_channels"] * d + (t + c) * cfg["context_in_dim"] * d
           + n_cond * (256 * d + cfg["vec_in_dim"] * d + 2 * d * d))
    per_double = (2 + (1 if c else 0)) * d * 6 * d + (t + p + c) * (3 * d * d + d * d + 2 * d * m)
    lin += cfg["depth"] * per_double
    attn = cfg["depth"] * 4.0 * d * concept_pairs(t, p, c)
    maps = cfg["depth"] * 2 * 2.0 * c * p * d
    if not stop_after_double:
        s = t + p
        lin += cfg["depth_single"] * (d * 3 * d + s * (3 * d * d + d * m + d * d + m * d))
        attn += cfg["depth_single"] * 4.0 * d * s * s
        lin += d * 2 * d + p * d * cfg["in_channels"]
    return {"linear": 2.0 * b * lin, "attention": b * attn, "maps": b * maps}


def flux_attention_bound_s(cfg: Dict, b: int, t: int, p: int, c: int,
                           stop_after_double: bool = False) -> float:
    """The attention launches of one forward: a joint concept launch a
    double block, a self-attention launch a single block."""
    h, hd = cfg["num_heads"], cfg["head_dim"]
    total = cfg["depth"] * attention_bound_s(b, h, hd, t + p + c, concept_pairs(t, p, c))
    if not stop_after_double:
        s = t + p
        total += cfg["depth_single"] * attention_bound_s(b, h, hd, s, s * s)
    return total


# ---------------------------------------------------------------- Flux VAE


def vae_layers(cfg: Dict, res: int, decoder: bool) -> Tuple[List[Tuple], List[Tuple]]:
    """The VAE's convolutions at image side `res` as (cin, cout, k, stride,
    h_out, w_out) and its attention as (tokens, channels). `cfg`: ch,
    ch_mult, num_res_blocks, z_channels, in_channels, out_ch."""
    ch, mult, nres = cfg["ch"], cfg["ch_mult"], cfg["num_res_blocks"]
    convs: List[Tuple] = []

    def resnet(c_in, c_out, r):
        convs.extend([(c_in, c_out, 3, 1, r, r), (c_out, c_out, 3, 1, r, r)])
        if c_in != c_out:
            convs.append((c_in, c_out, 1, 1, r, r))

    def mid(c, r):
        resnet(c, c, r)
        convs.extend([(c, c, 1, 1, r, r)] * 4)
        resnet(c, c, r)
        return [(r * r, c)]

    if decoder:
        r = res // 2 ** (len(mult) - 1)
        c = ch * mult[-1]
        convs.append((cfg["z_channels"], c, 3, 1, r, r))
        attn = mid(c, r)
        for i in reversed(range(len(mult))):
            for _ in range(nres + 1):
                resnet(c, ch * mult[i], r)
                c = ch * mult[i]
            if i != 0:
                r *= 2
                convs.append((c, c, 3, 1, r, r))
        convs.append((c, cfg["out_ch"], 3, 1, r, r))
        return convs, attn
    r, c = res, ch
    convs.append((cfg["in_channels"], ch, 3, 1, r, r))
    for i, mu in enumerate(mult):
        for _ in range(nres):
            resnet(c, ch * mu, r)
            c = ch * mu
        if i != len(mult) - 1:
            r //= 2
            convs.append((c, c, 3, 2, r, r))
    attn = mid(c, r)
    convs.append((c, 2 * cfg["z_channels"], 3, 1, r, r))
    return convs, attn


def conv_flops(cin: int, cout: int, k: int, h: int, w: int) -> float:
    return 2.0 * cin * cout * k * k * h * w


def vae_flops(cfg: Dict, res: int, decoder: bool) -> float:
    """Operations of one image through the encoder or the decoder."""
    convs, attn = vae_layers(cfg, res, decoder)
    return (sum(conv_flops(ci, co, k, h, w) for ci, co, k, _, h, w in convs)
            + sum(4.0 * s * s * c for s, c in attn))


def k2_convs(cfg: Dict, res: int) -> List[Tuple]:
    """The decoder's convolutions that the program routes to its 3x3 kernel:
    stride 1, Cin and Cout multiples of 128, H a multiple of 8, W >= 8."""
    convs, _ = vae_layers(cfg, res, decoder=True)
    return [x for x in convs if x[2] == 3 and x[3] == 1 and x[0] % 128 == 0 and x[1] % 128 == 0
            and x[4] % 8 == 0 and x[5] >= 8]


def conv_bound_s(convs, elem: int, peak: float) -> float:
    """Sum of each conv's bound: input, weight and output read or written once."""
    return sum(bound_s(conv_flops(ci, co, k, h, w),
                       elem * (ci * h * s * w * s + k * k * ci * co + co * h * w), peak)
               for ci, co, k, s, h, w in convs)


def vae_attention_bound_s(cfg: Dict, res: int) -> float:
    """The decoder's mid-attention as one bf16 head of `channels` width."""
    _, attn = vae_layers(cfg, res, decoder=True)
    return sum(attention_bound_s(1, 1, c, s, s * s) for s, c in attn)


# ---------------------------------------------------------------- CogVideoX


def video_forward_flops(cfg: Dict, b: int, t: int, p: int, c: int) -> Dict[str, float]:
    """One CogVideoX forward of b rows, t text, p video and c concept tokens.
    `cfg`: hidden, time_embed_dim, in_channels, out_channels, patch_size,
    text_embed_dim, num_layers."""
    d, te, pp = cfg["hidden"], cfg["time_embed_dim"], cfg["patch_size"] ** 2
    lin = (d * te + te * te + p * cfg["in_channels"] * pp * d + (t + c) * cfg["text_embed_dim"] * d
           + te * 2 * d + p * d * cfg["out_channels"] * pp)
    per_layer = 4 * te * 6 * d + (t + p + c) * (3 * d * d + d * d + 8 * d * d)
    lin += cfg["num_layers"] * per_layer
    attn = cfg["num_layers"] * 4.0 * d * concept_pairs(t, p, c)
    maps = cfg["num_layers"] * 2.0 * c * p * d
    return {"linear": 2.0 * b * lin, "attention": b * attn, "maps": b * maps}


def video_attention_bound_s(cfg: Dict, b: int, t: int, p: int, c: int) -> float:
    return cfg["num_layers"] * attention_bound_s(b, cfg["num_heads"], cfg["head_dim"], t + p + c,
                                                 concept_pairs(t, p, c))
