// Fused dual-pass concept flash attention for Hopper (sm_90a), bf16 in and out.
//
// Replaces, in the JAX package's kernels/flash_saliency.py:
//   K1 fused_concept_flash_attention (Pallas body _flash_kernel): one launch
//     covers a whole double block (joint txt+img pass and concept pass in one
//     sweep, so the image K/V stream once per query tile), a single block,
//     the flux VAE mid-attention, or a CogVideoX block (head dim 64);
//   K3 fused_concept_flash_attention_paired (Pallas body _flash_kernel_paired):
//     the same function for head dim 64, an even head count and RoPE, two
//     heads per block (entry point ca_flash_saliency_paired_bf16).
//
// What it computes, over the fused sequence S = [txt | img | concept | pad]:
//   q in txt|img   sees  k in txt|img
//   q in concept   sees  k in img      (if cross)
//                        k in concept  (if self_attn)
//   q in pad       sees  nothing -> exact zeros (the row sum stays 0)
// Online softmax in the exp2 domain (log2(e) folded into the scale). With
// RoPE tables (the expanded [B, S, D] f32 pair layout of expand_rope_tables)
// q is rotated and pre-scaled in f32 and rounded to bf16, k is rotated in f32
// and rounded, as the Pallas kernel does; without tables the f32 scores are
// scaled instead. P is rounded to bf16 for the P.V product; every product
// accumulates in f32.
//
// What bounds it on an H100: at the flux shapes (S = 4352 + C, d = 128) the
// work is ~4 S^2 d flops per head against ~8 S d bytes of q/k/v/out, some
// 2000 flops per byte, far above the card's ~295 ridge; at the CogVideoX
// shape (S = 18002, d = 64) some 4500. Tensor-core throughput bounds it, not
// HBM. The design:
//   - a block of 8 warps per (b*h / NH, 128-query tile, D chunk), a loop over
//     64-key tiles that skips tiles the segment mask leaves empty; masking
//     per element only in tiles the mask cuts;
//   - mma.sync m16n8k16 bf16 with f32 accumulators, operands from shared
//     memory through ldmatrix; each warp owns 16 query rows and keeps its
//     scores, probabilities (re-packed as the A operand of P.V) and running
//     output in registers, so the per-row rescale is register arithmetic;
//   - V arrives by cp.async while K is rotated through registers;
//   - the output's D columns are split into chunks of at most 128 across
//     blockIdx.z, so D = 512 (the VAE's one head over S = 16384) keeps a
//     16 x 128 f32 accumulator per warp like D = 128; each chunk recomputes
//     the scores (and identical row statistics) for its columns.
// K3 (NH = 2, D = 64): the two heads of a pair share positions, so they share
// the RoPE tables and the mask. Each key tile's cos/sin are read once (from
// L2, f32) and rotate both heads' K; tile_reachable / tile_full and the
// per-element mask bits are computed once per tile for both heads; each warp
// keeps two 16 x 64 f32 accumulators and a running max and sum per head, the
// register footprint of the D = 128 instance. The TPU kernel's block-diagonal
// [[k1|0],[0|k2]] packing is not copied: mma.sync gains nothing from zeros.
// Still single-stage per key tile and on mma.sync: wgmma, TMA and warp
// specialisation are later work.

#include "flash_common.cuh"

namespace {

template <int D, int DC, int NH>
struct Smem {
  static constexpr int LDQ = D + 8;   // bf16 rows of q and k (16-byte pad: no ldmatrix conflicts)
  static constexpr int LDV = DC + 8;  // bf16 rows of the v chunk
  static constexpr size_t bytes =
      sizeof(__nv_bfloat16) * NH * ((size_t)BQ * LDQ + (size_t)BK * LDQ + (size_t)BK * LDV);
};

// NH heads per block: 1 for K1, 2 for K3 (the heads of a pair share the
// batch row, so the RoPE tables and the segment mask).
template <int D, int DC, int NH>
__global__ void __launch_bounds__(NT, 1)
flash_saliency_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ rope_cos,
                      const float* __restrict__ rope_sin, __nv_bfloat16* __restrict__ out,
                      int num_heads, Segments g, float scale) {
  static_assert(D % 16 == 0 && DC % 16 == 0 && D % DC == 0, "tile shapes");
  using L = Smem<D, DC, NH>;
  constexpr int LDQ = L::LDQ, LDV = L::LDV;
  constexpr int NS = BK / 8;   // 8-key score tiles per warp row block
  constexpr int NO = DC / 8;   // 8-column output tiles per warp row block
  static_assert(NS * 4 == 32, "one mask bit per score element of a lane");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [NH][BQ][LDQ]
  __nv_bfloat16* sK = sQ + NH * BQ * LDQ;                           // [NH][BK][LDQ]
  __nv_bfloat16* sV = sK + NH * BK * LDQ;                           // [NH][BK][LDV]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad_row = lane >> 2, quad_col = (lane & 3) * 2;
  const int bh0 = blockIdx.y * NH, b = bh0 / num_heads;
  const int q0 = blockIdx.x * BQ, col0 = blockIdx.z * DC;
  const int S = g.seq_len;
  const size_t head_stride = (size_t)S * D;
  const size_t head0 = (size_t)bh0 * head_stride;
  const bool rope = rope_cos != nullptr;
  const float* cos_b = rope ? rope_cos + (size_t)b * S * D : nullptr;
  const float* sin_b = rope ? rope_sin + (size_t)b * S * D : nullptr;
  const float score_mul = rope ? 1.f : scale;

  // q tiles, roped and pre-scaled in f32 when tables are given; each table
  // entry is read once for all NH heads.
  for (int e = tid; e < BQ * D / 8; e += NT) {
    const int r = e / (D / 8), c = (e % (D / 8)) * 8, gq = q0 + r;
    Rot8 t;
    if (rope && gq < S) t = load_rot8(cos_b + (size_t)gq * D + c, sin_b + (size_t)gq * D + c);
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      uint4 val = make_uint4(0, 0, 0, 0);
      if (gq < S) {
        val = *reinterpret_cast<const uint4*>(q + head0 + hh * head_stride + (size_t)gq * D + c);
        if (rope) val = rotate8(val, t, scale);
      }
      *reinterpret_cast<uint4*>(sQ + (hh * BQ + r) * LDQ + c) = val;
    }
  }

  const int w0 = warp * 16;  // this warp's first query row in the tile
  const int gq_lo = q0 + w0 + quad_row, gq_hi = gq_lo + 8;
  float o[NH][NO][4];
  float m_lo[NH], m_hi[NH], l_lo[NH], l_hi[NH];
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
    for (int j = 0; j < NO; ++j) o[hh][j][0] = o[hh][j][1] = o[hh][j][2] = o[hh][j][3] = 0.f;
    m_lo[hh] = m_hi[hh] = -INFINITY;
    l_lo[hh] = l_hi[hh] = 0.f;
  }

  for (int k0 = 0; k0 < S; k0 += BK) {
    if (!tile_reachable(g, q0, BQ, k0, BK)) continue;
    __syncthreads();  // the previous tile's reads of sK / sV are done

    for (int e = tid; e < BK * DC / 8; e += NT) {  // v chunks by cp.async
      const int r = e / (DC / 8), c = (e % (DC / 8)) * 8, gk = k0 + r;
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
        __nv_bfloat16* dst = sV + (hh * BK + r) * LDV + c;
        if (gk < S) {
          cp_async16(dst, v + head0 + hh * head_stride + (size_t)gk * D + col0 + c);
        } else {  // the ragged tail stays zero: no garbage reaches P.V
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    for (int e = tid; e < BK * D / 8; e += NT) {  // k, roped through registers
      const int r = e / (D / 8), c = (e % (D / 8)) * 8, gk = k0 + r;
      Rot8 t;
      if (rope && gk < S) t = load_rot8(cos_b + (size_t)gk * D + c, sin_b + (size_t)gk * D + c);
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
        uint4 val = make_uint4(0, 0, 0, 0);
        if (gk < S) {
          val = *reinterpret_cast<const uint4*>(k + head0 + hh * head_stride + (size_t)gk * D + c);
          if (rope) val = rotate8(val, t, 1.f);
        }
        *reinterpret_cast<uint4*>(sK + (hh * BK + r) * LDQ + c) = val;
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    if (!tile_reachable(g, q0 + w0, 16, k0, BK)) continue;  // warp-uniform

    // Mask bits of this lane's score elements (bit 4j + e), shared by the
    // NH heads; all set when the tile needs no per-element mask.
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

#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      const __nv_bfloat16* sQh = sQ + hh * BQ * LDQ;
      const __nv_bfloat16* sKh = sK + hh * BK * LDQ;
      const __nv_bfloat16* sVh = sV + hh * BK * LDV;

      // Scores of this warp's 16 rows against the BK keys.
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, sQh + (w0 + (lane & 15)) * LDQ + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int n = 0; n < NS / 2; ++n) {
          uint32_t kb[4];
          ldmatrix_x4(kb, sKh + (n * 16 + (lane & 7) + (lane >> 4) * 8) * LDQ + kk * 16 +
                              ((lane >> 3) & 1) * 8);
          mma_bf16(s[2 * n], a, kb[0], kb[1]);
          mma_bf16(s[2 * n + 1], a, kb[2], kb[3]);
        }
      }

      // Online softmax update of rows gq_lo (elements 0, 1) and gq_hi (2, 3);
      // the four lanes of a quad share a row.
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = (ok_bits >> (4 * j + e)) & 1u ? s[j][e] * score_mul : -INFINITY;
        }
        mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float mn_lo = fmaxf(m_lo[hh], mx_lo), mn_hi = fmaxf(m_hi[hh], mx_hi);
      // A row that has seen no key yet keeps max -inf: exp2 against 0 then
      // gives exact zeros, and the (zero) running output needs no rescale.
      const float ref_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
      const float ref_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
      const float alpha_lo = exp2f(m_lo[hh] - ref_lo), alpha_hi = exp2f(m_hi[hh] - ref_hi);
      m_lo[hh] = mn_lo;
      m_hi[hh] = mn_hi;
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
      l_lo[hh] = l_lo[hh] * alpha_lo + sum_lo;  // per-lane partial sums, reduced at the end
      l_hi[hh] = l_hi[hh] * alpha_hi + sum_hi;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[hh][j][0] *= alpha_lo;
        o[hh][j][1] *= alpha_lo;
        o[hh][j][2] *= alpha_hi;
        o[hh][j][3] *= alpha_hi;
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
          ldmatrix_x4_trans(vb, sVh + (t * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDV +
                                    n * 16 + (lane >> 4) * 8);
          mma_bf16(o[hh][2 * n], pa, vb[0], vb[1]);
          mma_bf16(o[hh][2 * n + 1], pa, vb[2], vb[3]);
        }
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
    float sl = l_lo[hh], sh = l_hi[hh];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      sl += __shfl_xor_sync(0xffffffffu, sl, off);
      sh += __shfl_xor_sync(0xffffffffu, sh, off);
    }
    const float inv_lo = sl == 0.f ? 0.f : 1.f / sl;  // empty rows: exact zeros
    const float inv_hi = sh == 0.f ? 0.f : 1.f / sh;
    __nv_bfloat16* out_h = out + head0 + hh * head_stride;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int c = col0 + j * 8 + quad_col;
      if (gq_lo < S) {
        *reinterpret_cast<uint32_t*>(out_h + (size_t)gq_lo * D + c) =
            pack_bf16(o[hh][j][0] * inv_lo, o[hh][j][1] * inv_lo);
      }
      if (gq_hi < S) {
        *reinterpret_cast<uint32_t*>(out_h + (size_t)gq_hi * D + c) =
            pack_bf16(o[hh][j][2] * inv_hi, o[hh][j][3] * inv_hi);
      }
    }
  }
}

template <int D, int DC, int NH>
cudaError_t launch(const void* q, const void* k, const void* v, const void* rope_cos,
                   const void* rope_sin, void* out, int batch, int heads, Segments g,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = Smem<D, DC, NH>::bytes;
  auto kernel = flash_saliency_kernel<D, DC, NH>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.seq_len + BQ - 1) / BQ, batch * heads / NH, D / DC);
  kernel<<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(rope_cos),
      static_cast<const float*>(rope_sin), static_cast<__nv_bfloat16*>(out), heads, g, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, out: [B, H, S, D] bf16, contiguous. rope_cos / rope_sin: [B, S, D]
// f32 or both null. scale = log2(e) / sqrt(D). Returns a cudaError_t.
int ca_flash_saliency_bf16(const void* q, const void* k, const void* v, const void* rope_cos,
                           const void* rope_sin, void* out, int batch, int heads, int seq_len,
                           int head_dim, int txt_len, int img_len, int concept_len, int cross,
                           int self_attn, float scale, void* stream) {
  const Segments g = make_segments(seq_len, txt_len, img_len, concept_len, cross, self_attn);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32, 32, 1>(q, k, v, rope_cos, rope_sin, out, batch, heads, g, scale, s);
    case 64:
      return launch<64, 64, 1>(q, k, v, rope_cos, rope_sin, out, batch, heads, g, scale, s);
    case 128:
      return launch<128, 128, 1>(q, k, v, rope_cos, rope_sin, out, batch, heads, g, scale, s);
    case 512:
      return launch<512, 128, 1>(q, k, v, rope_cos, rope_sin, out, batch, heads, g, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// K3: the same contract for head_dim 64, an even head count and both RoPE
// tables, two heads per block.
int ca_flash_saliency_paired_bf16(const void* q, const void* k, const void* v,
                                  const void* rope_cos, const void* rope_sin, void* out,
                                  int batch, int heads, int seq_len, int head_dim, int txt_len,
                                  int img_len, int concept_len, int cross, int self_attn,
                                  float scale, void* stream) {
  if (head_dim != 64 || heads % 2 != 0 || rope_cos == nullptr || rope_sin == nullptr) {
    return cudaErrorInvalidValue;
  }
  const Segments g = make_segments(seq_len, txt_len, img_len, concept_len, cross, self_attn);
  return launch<64, 64, 2>(q, k, v, rope_cos, rope_sin, out, batch, heads, g, scale,
                           static_cast<cudaStream_t>(stream));
}

const char* ca_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
