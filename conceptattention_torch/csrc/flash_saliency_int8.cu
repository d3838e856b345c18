// Fused dual-pass concept flash attention with int8 q/k scores for Hopper
// (sm_90a): K1b, bf16 v and output.
//
// Replaces, in the JAX package's kernels/flash_saliency.py, the int8_qk=True
// variant of fused_concept_flash_attention (Pallas body _flash_kernel:
// _quantize_rows and the int8 _scores branch). The function is K1's (the
// segment mask over S = [txt | img | concept | pad], the exp2 online
// softmax, P rounded to bf16, f32 P.V, exact zeros for rows that see
// nothing) with per-row symmetric int8 q and k:
//   s = max|x| * (1/127)  (f32; XLA turns the division by 127 into this)
//   x8 = round_half_even(x / max(s, 1e-9))
//   score = float(q8 . k8) * (s_q * s_k)          with RoPE tables
//   score = float(q8 . k8) * (s_q * s_k) * scale  without
// With tables, q is roped and pre-scaled by log2(e)/sqrt(D) in f32 and
// quantized from that f32 value; k is roped, rounded to bf16, and quantized.
// Every product, sum and quotient of the quantizer is an explicit _rn
// intrinsic, so nvcc contracts nothing into an FMA and the int8 rows equal
// the plain PyTorch quantizer's bit for bit.
//
// Two launches per call: the pre-pass, then the main kernel of this file at
// head dims 32 and 64, or of csrc/flash_saliency_int8_sm90.cu (TMA, an
// mbarrier ring and s8 wgmma) at head dim 128, where this file's instance
// is kept only as the smoke's yardstick:
//   1. ca_flash_saliency_int8_prepass: one pass over q and k that ropes,
//      scales and quantizes each row once (K1 rotates every key row once per
//      query tile) and writes int8 [B, H, S, D] rows and f32 [B, H, S]
//      scales;
//   2. ca_flash_saliency_int8: K1's block structure (8 warps, 128 query
//      rows, 64-key tiles, tiles the mask leaves empty skipped) with int8 q
//      and k tiles in shared memory (half of K1's bytes), scores from
//      mma.sync m16n8k32 s8 x s8 -> s32 (D/32 k-steps), then K1's softmax
//      and the bf16 m16n8k16 P.V product.
// A 16 x 32 int8 tile is 16 rows of 32 bytes, byte for byte the 16 x 16 bf16
// tile of K1's A operand, so ldmatrix .b16 loads the s8 A fragment
// unchanged, and key rows stored [key][channel] give the B fragment without
// .trans.
//
// What bounds it on an H100: at the flux shapes the int8 Q.K^T work
// (2 S^2 D ops at 1979 TOP/s) plus the bf16 P.V (2 S^2 D at 989 TFLOP/s) is
// far above the bytes moved; tensor-core throughput bounds it. The simple
// design here (single stage per key tile, mma.sync, no wgmma/TMA) serves the
// small head dims; the flux blocks' head dim 128 takes the Hopper kernel.

#include "flash_common.cuh"

namespace {

constexpr float kInv127 = 1.0f / 127.0f;

// One thread per 8 channels of a row (D / 8 threads per row); blockIdx.y
// picks q (0) or k (1).
template <int D>
__global__ void __launch_bounds__(NT)
quantize_rows_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const float* __restrict__ rope_cos, const float* __restrict__ rope_sin,
                     int8_t* __restrict__ q8, int8_t* __restrict__ k8, float* __restrict__ qs,
                     float* __restrict__ ks, int rows, int heads, int seq_len, float scale) {
  constexpr int TPR = D / 8;
  constexpr int RPB = NT / TPR;
  static_assert(32 % TPR == 0, "a row's threads sit in one warp");
  const bool is_k = blockIdx.y == 1;
  const int row = blockIdx.x * RPB + threadIdx.x / TPR;
  const int c = (threadIdx.x % TPR) * 8;
  const bool live = row < rows;
  float y[8];
  float amax = 0.f;
  if (live) {
    const uint4 raw = *reinterpret_cast<const uint4*>((is_k ? k : q) + (size_t)row * D + c);
    const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      y[2 * i] = __bfloat162float(xv[i].x);
      y[2 * i + 1] = __bfloat162float(xv[i].y);
    }
    if (rope_cos != nullptr) {
      const int s = row % seq_len, b = row / seq_len / heads;
      const size_t t = ((size_t)b * seq_len + s) * D + c;
      const Rot8 r = load_rot8(rope_cos + t, rope_sin + t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = y[2 * i], bb = y[2 * i + 1];
        float y0 = __fadd_rn(__fmul_rn(a, r.c[2 * i]), __fmul_rn(bb, r.s[2 * i]));
        float y1 = __fadd_rn(__fmul_rn(bb, r.c[2 * i + 1]), __fmul_rn(a, r.s[2 * i + 1]));
        if (is_k) {  // roped k is rounded to its dtype before it is quantized
          y0 = __bfloat162float(__float2bfloat16_rn(y0));
          y1 = __bfloat162float(__float2bfloat16_rn(y1));
        } else {  // roped q is pre-scaled and quantized from f32
          y0 = __fmul_rn(y0, scale);
          y1 = __fmul_rn(y1, scale);
        }
        y[2 * i] = y0;
        y[2 * i + 1] = y1;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(y[i]));
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  if (!live) return;
  const float s = __fmul_rn(amax, kInv127);
  const float den = fmaxf(s, 1e-9f);
  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int v = __float2int_rn(__fdiv_rn(y[i], den));  // round half to even
    packed[i / 4] |= (uint32_t)(uint8_t)(int8_t)v << (8 * (i % 4));
  }
  *reinterpret_cast<uint2*>((is_k ? k8 : q8) + (size_t)row * D + c) =
      make_uint2(packed[0], packed[1]);
  if (threadIdx.x % TPR == 0) (is_k ? ks : qs)[row] = s;
}

// c (16x8 s32) += a (16x32 s8, row-major) * b (32x8 s8, column-major).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int D>
struct SmemI8 {
  static constexpr int LDQ = D + 16;  // int8 rows of q and k, bytes (16-byte pad)
  static constexpr int LDV = D + 8;   // bf16 rows of v
  static constexpr size_t bytes = (size_t)BQ * LDQ + (size_t)BK * LDQ +
                                  sizeof(__nv_bfloat16) * BK * LDV + sizeof(float) * BK;
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_saliency_int8_kernel(const int8_t* __restrict__ q8, const int8_t* __restrict__ k8,
                           const float* __restrict__ qs, const float* __restrict__ ks,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                           Segments g, float score_mul) {
  static_assert(D % 32 == 0 && D <= 128, "head dims 32, 64, 128");
  using L = SmemI8<D>;
  constexpr int LDQ = L::LDQ, LDV = L::LDV;
  constexpr int NS = BK / 8;  // 8-key score tiles per warp row block
  constexpr int NO = D / 8;   // 8-column output tiles per warp row block
  static_assert(NS * 4 == 32, "one mask bit per score element of a lane");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  int8_t* sQ = reinterpret_cast<int8_t*>(smem_raw);                    // [BQ][LDQ]
  int8_t* sK = sQ + BQ * LDQ;                                          // [BK][LDQ]
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(sK + BK * LDQ);  // [BK][LDV]
  float* sKs = reinterpret_cast<float*>(sV + BK * LDV);                // [BK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad_row = lane >> 2, quad_col = (lane & 3) * 2;
  const int q0 = blockIdx.x * BQ;
  const int S = g.seq_len;
  const size_t row0 = (size_t)blockIdx.y * S;  // this head's first row
  const size_t head0 = row0 * D;

  for (int e = tid; e < BQ * D / 16; e += NT) {
    const int r = e / (D / 16), c = (e % (D / 16)) * 16, gq = q0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (gq < S) val = *reinterpret_cast<const uint4*>(q8 + head0 + (size_t)gq * D + c);
    *reinterpret_cast<uint4*>(sQ + r * LDQ + c) = val;
  }

  const int w0 = warp * 16;  // this warp's first query row in the tile
  const int gq_lo = q0 + w0 + quad_row, gq_hi = gq_lo + 8;
  const float qs_lo = gq_lo < S ? qs[row0 + gq_lo] : 0.f;
  const float qs_hi = gq_hi < S ? qs[row0 + gq_hi] : 0.f;
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  for (int k0 = 0; k0 < S; k0 += BK) {
    if (!tile_reachable(g, q0, BQ, k0, BK)) continue;
    __syncthreads();  // the previous tile's reads of sK / sV / sKs are done

    for (int e = tid; e < BK * D / 8; e += NT) {  // v by cp.async
      const int r = e / (D / 8), c = (e % (D / 8)) * 8, gk = k0 + r;
      __nv_bfloat16* dst = sV + r * LDV + c;
      if (gk < S) {
        cp_async16(dst, v + head0 + (size_t)gk * D + c);
      } else {  // the ragged tail stays zero: no garbage reaches P.V
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
    for (int e = tid; e < BK * D / 16; e += NT) {  // int8 k by cp.async
      const int r = e / (D / 16), c = (e % (D / 16)) * 16, gk = k0 + r;
      int8_t* dst = sK + r * LDQ + c;
      if (gk < S) {
        cp_async16(dst, k8 + head0 + (size_t)gk * D + c);
      } else {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    for (int e = tid; e < BK; e += NT) sKs[e] = k0 + e < S ? ks[row0 + k0 + e] : 0.f;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    if (!tile_reachable(g, q0 + w0, 16, k0, BK)) continue;  // warp-uniform

    // Mask bits of this lane's score elements (bit 4j + e); all set when the
    // tile needs no per-element mask.
    const bool full = tile_full(g, q0 + w0, 16, k0, BK) && k0 + BK <= S && q0 + w0 + 16 <= S;
    uint32_t ok_bits = 0xffffffffu;
    if (!full) {
      ok_bits = 0;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kc = k0 + j * 8 + quad_col + (e & 1);
          ok_bits |= (uint32_t)allowed(g, e < 2 ? gq_lo : gq_hi, kc) << (4 * j + e);
        }
      }
    }

    // int8 scores of this warp's 16 rows against the BK keys, int32 sums.
    int acc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, sQ + (w0 + (lane & 15)) * LDQ + kk * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int n = 0; n < NS / 2; ++n) {
        uint32_t kb[4];
        ldmatrix_x4(kb, sK + (n * 16 + (lane & 7) + (lane >> 4) * 8) * LDQ + kk * 32 +
                            ((lane >> 3) & 1) * 16);
        mma_s8(acc[2 * n], a, kb[0], kb[1]);
        mma_s8(acc[2 * n + 1], a, kb[2], kb[3]);
      }
    }

    // Scores back to f32 with the row scales, then K1's online softmax update
    // of rows gq_lo (elements 0, 1) and gq_hi (2, 3).
    float s[NS][4];
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float rs = __fmul_rn(e < 2 ? qs_lo : qs_hi, sKs[j * 8 + quad_col + (e & 1)]);
        const float sc = __fmul_rn(__fmul_rn(__int2float_rn(acc[j][e]), rs), score_mul);
        s[j][e] = (ok_bits >> (4 * j + e)) & 1u ? sc : -INFINITY;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    // A row that has seen no key yet keeps max -inf: exp2 against 0 then
    // gives exact zeros, and the (zero) running output needs no rescale.
    const float ref_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
    const float ref_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    const float alpha_lo = exp2f(m_lo - ref_lo), alpha_hi = exp2f(m_hi - ref_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = exp2f(s[j][0] - ref_lo);
      s[j][1] = exp2f(s[j][1] - ref_lo);
      s[j][2] = exp2f(s[j][2] - ref_hi);
      s[j][3] = exp2f(s[j][3] - ref_hi);
      sum_lo += s[j][0] + s[j][1];
      sum_hi += s[j][2] + s[j][3];
    }
    l_lo = l_lo * alpha_lo + sum_lo;  // per-lane partial sums, reduced at the end
    l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][0] *= alpha_lo;
      o[j][1] *= alpha_lo;
      o[j][2] *= alpha_hi;
      o[j][3] *= alpha_hi;
    }

    // o += P V: the score accumulators of key tiles 2t and 2t+1 are, packed
    // to bf16, the A fragment of the 16-key step t.
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      const uint32_t pa[4] = {pack_bf16(s[2 * t][0], s[2 * t][1]),
                              pack_bf16(s[2 * t][2], s[2 * t][3]),
                              pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]),
                              pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3])};
#pragma unroll
      for (int n = 0; n < NO / 2; ++n) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, sV + (t * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV + n * 16 +
                                  (lane >> 4) * 8);
        mma_bf16(o[2 * n], pa, vb[0], vb[1]);
        mma_bf16(o[2 * n + 1], pa, vb[2], vb[3]);
      }
    }
  }

  float sl = l_lo, sh = l_hi;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    sl += __shfl_xor_sync(0xffffffffu, sl, off);
    sh += __shfl_xor_sync(0xffffffffu, sh, off);
  }
  const float inv_lo = sl == 0.f ? 0.f : 1.f / sl;  // empty rows: exact zeros
  const float inv_hi = sh == 0.f ? 0.f : 1.f / sh;
  __nv_bfloat16* out_h = out + head0;
#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int c = j * 8 + quad_col;
    if (gq_lo < S) {
      *reinterpret_cast<uint32_t*>(out_h + (size_t)gq_lo * D + c) =
          pack_bf16(o[j][0] * inv_lo, o[j][1] * inv_lo);
    }
    if (gq_hi < S) {
      *reinterpret_cast<uint32_t*>(out_h + (size_t)gq_hi * D + c) =
          pack_bf16(o[j][2] * inv_hi, o[j][3] * inv_hi);
    }
  }
}

template <int D>
cudaError_t launch_prepass(const void* q, const void* k, const void* rope_cos, const void* rope_sin,
                           void* q8, void* k8, void* qs, void* ks, int rows, int heads,
                           int seq_len, float scale, cudaStream_t stream) {
  constexpr int RPB = NT / (D / 8);
  const dim3 grid((rows + RPB - 1) / RPB, 2);
  quantize_rows_kernel<D><<<grid, NT, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const float*>(rope_cos), static_cast<const float*>(rope_sin),
      static_cast<int8_t*>(q8), static_cast<int8_t*>(k8), static_cast<float*>(qs),
      static_cast<float*>(ks), rows, heads, seq_len, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_main(const void* q8, const void* k8, const void* qs, const void* ks,
                        const void* v, void* out, int batch, int heads, Segments g,
                        float score_mul, cudaStream_t stream) {
  constexpr size_t smem = SmemI8<D>::bytes;
  auto kernel = flash_saliency_int8_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.seq_len + BQ - 1) / BQ, batch * heads);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8),
      static_cast<const float*>(qs), static_cast<const float*>(ks),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), g, score_mul);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k: [B, H, S, D] bf16, contiguous; rope_cos / rope_sin: [B, S, D] f32 or
// both null; scale = log2(e) / sqrt(D) (applied to roped q only). Writes
// q8, k8: [B, H, S, D] int8 and qs, ks: [B, H, S] f32. Returns a cudaError_t.
int ca_flash_saliency_int8_prepass(const void* q, const void* k, const void* rope_cos,
                                   const void* rope_sin, void* q8, void* k8, void* qs, void* ks,
                                   int batch, int heads, int seq_len, int head_dim, float scale,
                                   void* stream) {
  const int rows = batch * heads * seq_len;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_prepass<32>(q, k, rope_cos, rope_sin, q8, k8, qs, ks, rows, heads, seq_len,
                                scale, s);
    case 64:
      return launch_prepass<64>(q, k, rope_cos, rope_sin, q8, k8, qs, ks, rows, heads, seq_len,
                                scale, s);
    case 128:
      return launch_prepass<128>(q, k, rope_cos, rope_sin, q8, k8, qs, ks, rows, heads, seq_len,
                                 scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// q8, k8: [B, H, S, D] int8 and qs, ks: [B, H, S] f32 from the pre-pass; v,
// out: [B, H, S, D] bf16. score_mul = 1 when the pre-pass roped and scaled
// q, else log2(e) / sqrt(D). Returns a cudaError_t.
int ca_flash_saliency_int8(const void* q8, const void* k8, const void* qs, const void* ks,
                           const void* v, void* out, int batch, int heads, int seq_len,
                           int head_dim, int txt_len, int img_len, int concept_len, int cross,
                           int self_attn, float score_mul, void* stream) {
  const Segments g = make_segments(seq_len, txt_len, img_len, concept_len, cross, self_attn);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch_main<32>(q8, k8, qs, ks, v, out, batch, heads, g, score_mul, s);
    case 64:
      return launch_main<64>(q8, k8, qs, ks, v, out, batch, heads, g, score_mul, s);
    case 128:
      return launch_main<128>(q8, k8, qs, ks, v, out, batch, heads, g, score_mul, s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* ca_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
