// Fused dual-pass concept flash attention with int8 q/k scores, redesigned
// for Hopper (sm_90a): K1b at head dim 128. bf16 v and output.
//
// Replaces, in the JAX package's kernels/flash_saliency.py, the int8_qk=True
// variant of fused_concept_flash_attention (Pallas body _flash_kernel:
// _quantize_rows, the fused-rope int8 cache fill and the int8 _scores
// branch) at head dim 128: the flux double blocks (S = 4355 with concepts)
// and single blocks (S = 4352), at batch 1 and 2. Head dims 32 and 64 stay on
// csrc/flash_saliency_int8.cu, whose pre-pass this kernel's wrapper runs
// first: it ropes, pre-scales and quantizes every q and k row once into int8
// [B, H, S, D] rows and f32 [B, H, S] scales.
//
// The function is the mma.sync kernel's: per-row symmetric int8 q and k,
//   score = f32(q8 . k8) * (s_q * s_k)   (times log2(e)/sqrt(D), through
//                                          score_mul, without RoPE tables),
// K1's segment mask, the exp2 online softmax, P rounded to bf16, f32 P.V,
// exact zeros for rows that see nothing. The key scales are applied to the
// sums before the mask; the row scale s_q * score_mul is the softmax's
// multiplier of the row (its exp2 argument is one FMA, as K1's), held at
// FLT_MIN or more: a row whose q is all zeros (s_q = 0) then scores about
// 1e-33 against every visible key, exp2 of which is exactly 1, so it gets
// uniform weights, as the plain version gives it, and its masked scores stay
// -inf (-inf * 0 would be NaN).
//
// What bounds it on an H100: at the flux shapes the int8 Q.K^T (2 S^2 D ops
// at 1979 TOP/s) and the bf16 P.V (2 S^2 D at 989 TFLOP/s) are far above the
// bytes moved: the tensor cores, and beside them the exponentials and the
// per-score arithmetic of the softmax. The design is K1's at head dim 128 on
// the mainloop of flash_sm90.cuh (a producer warpgroup's thread issues every
// TMA copy into a two-stage mbarrier ring; two consumer warpgroups of 64
// query rows run wgmma Q K^T, the online softmax on the accumulator registers
// and wgmma P V with P from registers), with its Q K^T made int8 (Int8QK) and
// the consumers taking turns at the tensor cores (PINGPONG):
//   - an int8 row of 128 channels is 128 bytes, one 128-byte swizzle atom:
//     the Q and K tiles are byte for byte K1's bf16 tiles at head dim 64
//     (TMA boxes of 128 bytes x rows under 128-byte swizzle, the same wgmma
//     descriptors), half of K1's bytes at head dim 128 (a ring of four
//     stages fits, and timed no faster than two);
//   - wgmma m64n128k32 s8 x s8 -> s32 with both operands K-major in shared
//     memory (the only layout wgmma takes for 8-bit types, and what [row]
//     [channel] rows of q8 and k8 are), four k-steps of 32 bytes;
//   - the f32 scales of a tile's 128 keys land in its ring stage beside the
//     K tile, on the same barrier, through a 1D tensor map over the
//     [B * H * S] scales: a row of S = 4355 scales is 17420 bytes, not a
//     multiple of 16, so no 2D map takes it, and a TMA box must start on a
//     16-byte boundary (one that did not never completed its barrier on the
//     card), so each box starts at the multiple of 4 scales at or below the
//     tile's first key and is 132 scales long, and a block reads them from
//     the offset (bh * S) % 4; a tile's tail past S reads the next head's
//     scales, for keys the mask drops, and past the tensor's end zeros;
//     each consumer thread loads its two rows' s_q once per block;
//   - the s32 sums become f32 without I2F (cvt runs at a quarter of the
//     rate of the pipe that also runs ex2, which paces K1): |q8 . k8| <=
//     127^2 * 128 < 2^22, so adding 0x4B400000 as an integer and
//     subtracting 12582912.0f as a float is exact, in full-rate integer and
//     float adds; with the key scale that is three instructions a score
//     beside K1's (the row scale rides in the softmax's FMA).
//   - the int8 Q K^T takes half of the bf16 one's tensor time, but each
//     score costs three more instructions (conversion and key scale) in a
//     softmax that already paced K1. PINGPONG hands the tensor cores from
//     one consumer warpgroup to the other (a warpgroup issues its P.V and
//     next Q K^T in its turn, then runs its softmax while the other issues);
//     this kernel timed faster with it than with IN_ORDER (K1's schedule at
//     this head dim) at every flux shape, with the same registers (168, no
//     spills). Issuing the P.V and the next Q K^T as one burst before the
//     softmax instead spilled and serialised wgmma.
// The s32 accumulator has the f32 accumulator's fragment layout, so the
// softmax's row and key indexing is K1's.

#include <float.h>

#include "flash_sm90.cuh"

namespace {

constexpr int I8_D = 128, I8_HK = 128, I8_STAGES = 2;

// S = Q K^T in s32 for one warpgroup's 64 rows and an HK-key tile of int8
// rows (D bytes a row, D / 128 atoms, both K-major in shared memory, Q's of
// HQ rows), committed as one group; issue_qk's byte arithmetic with 32-deep
// k-steps of 32 bytes.
template <int D, int HK>
__device__ __forceinline__ void issue_qk_s8(int (&s)[HK / 2], const unsigned char* sQw,
                                            const unsigned char* sKs) {
  static_assert(HK == 128, "one m64n128k32 product per k-step");
  constexpr uint32_t Q_ATOM = HQ * 128, K_ATOM = HK * 128;
  const uint64_t qd = opaque(desc_sw128(sQw, 16, 1024)), kd = opaque(desc_sw128(sKs, 16, 1024));
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t da = qd + (((kk / 4) * Q_ATOM + off) >> 4);
    const uint64_t db = kd + (((kk / 4) * K_ATOM + off) >> 4);
    wgmma_m64n128k32_s8_ss(s, da, db, kk > 0);
  }
  wgmma_commit();
}

// The exact f32 of an s32 with |x| < 2^22: x added to the mantissa of
// 1.5 * 2^23, then 1.5 * 2^23 taken away.
__device__ __forceinline__ float exact_f32(int x) {
  return __fsub_rn(__int_as_float(x + 0x4B400000), 12582912.0f);
}

// K1b's Q K^T for the mainloop: int8 rows of D bytes, the HK f32 key scales
// beside each K tile, the s32 sums turned into f32(q8 . k8) * s_k, and s_q
// in the softmax's multiplier of each row.
template <int D, int HK>
struct Int8QK {
  static_assert(D % 128 == 0, "whole 128-byte rows of int8 channels");
  using Acc = int;
  static constexpr int ATOMS = D / 128, ATOM_COLS = 128;
  static constexpr int KS_BOX = HK + 4;  // scales a box: the tile's keys from a 16-byte boundary
  static constexpr uint32_t EXTRA_BYTES = KS_BOX * sizeof(float);
  static constexpr uint32_t EXTRA_STRIDE = (EXTRA_BYTES + 127) / 128 * 128;

  const CUtensorMap* map_ks;  // the producer's: the [B * H * S] key scales
  int seq_len;
  int ks_off;                 // a consumer thread's: where its block's tile scales start in a box,
  float qs_lo, qs_hi;         // and the scales of its two rows

  __device__ __forceinline__ void produce_extra(unsigned char* dst, uint64_t* bar, int t,
                                                int bh) const {
    tma_load_1d(dst, map_ks, bar, (bh * seq_len + t * HK) & ~3);
  }

  static __device__ __forceinline__ void issue(int (&acc)[HK / 2], const unsigned char* sQw,
                                               const unsigned char* sKs) {
    issue_qk_s8<D, HK>(acc, sQw, sKs);
  }

  // Score element i of the thread sits at row (i & 2 ? hi : lo), key
  // 8 * (i / 4) + qc + (i & 1) of the tile (the keys' scales at ks_tile).
  // The warp's reads of the scales are done before its lane 0 releases the
  // slot.
  __device__ __forceinline__ auto& scores(int (&acc)[HK / 2], float (&f)[HK / 2],
                                          const unsigned char* ks_tile, int qc) const {
    const float* ks = reinterpret_cast<const float*>(ks_tile) + ks_off + qc;
#pragma unroll
    for (int j = 0; j < HK / 8; ++j) {
      const float k0 = ld_shared_f32(ks + 8 * j), k1 = ld_shared_f32(ks + 8 * j + 1);
      f[4 * j] = __fmul_rn(exact_f32(acc[4 * j]), k0);
      f[4 * j + 1] = __fmul_rn(exact_f32(acc[4 * j + 1]), k1);
      f[4 * j + 2] = __fmul_rn(exact_f32(acc[4 * j + 2]), k0);
      f[4 * j + 3] = __fmul_rn(exact_f32(acc[4 * j + 3]), k1);
    }
    __syncwarp();
    return f;
  }

  // The softmax's multipliers of the two rows: s_q * score_mul, at least
  // FLT_MIN.
  __device__ __forceinline__ float2 row_mul(float score_mul) const {
    return make_float2(fmaxf(__fmul_rn(qs_lo, score_mul), FLT_MIN),
                       fmaxf(__fmul_rn(qs_hi, score_mul), FLT_MIN));
  }
};

// q8, k8: [B*H, S, D] int8 rows through 3D tensor maps (box 128 x HQ or HK
// rows x 1 head); ks: the [B*H*S] f32 key scales through a 1D map (box
// HK + 4);
// qs: [B*H, S] f32 row scales; v: [B*H, S, D] bf16 (box 64 x HK x 1); out:
// [B*H, S, D] bf16. Block (query tile, head). Warpgroups 0 and 1 consume;
// warpgroup 2 produces, one thread issuing every copy. A block whose rows see
// no key loads nothing and writes zeros.
template <int D, int HK, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
flash_saliency_int8_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                                const __grid_constant__ CUtensorMap map_k,
                                const __grid_constant__ CUtensorMap map_ks,
                                const __grid_constant__ CUtensorMap map_v,
                                const float* __restrict__ qs, __nv_bfloat16* __restrict__ out,
                                Segments g, float score_mul) {
  using QK = Int8QK<D, HK>;
  using ML = Mainloop<D, D, HK, STAGES, PINGPONG, QK>;
  constexpr uint32_t Q_BYTES = QK::ATOMS * HQ * 128;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);  // [D / 128 atoms][HQ rows][128 B]
  const typename ML::Ring ring{sQ + Q_BYTES};
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring.end());

  const int lane = threadIdx.x & 31;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform role
  const int q0 = blockIdx.x * HQ, bh = blockIdx.y;
  const int S = g.seq_len;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    ring.init();
    fence_barrier_init();
  }
  __syncthreads();

  const int2 run = reachable_tiles<HK>(g, q0, HQ, 0, S);
  const int t0 = run.x, t1 = run.y, n = t1 - t0;  // uniform over the block

  if (wg == CONSUMERS / 128) {  // the producer warpgroup
    if (threadIdx.x == CONSUMERS && n > 0) {
      produce_q<D, QK::ATOMS, QK::ATOM_COLS>(sQ, &map_q, q_full, q0, bh);
      ring.produce(&map_k, &map_v, 0, t0, t1, bh, 0, QK{&map_ks, S, 0, 0.f, 0.f});
    }
    return;
  }

  // Consumers: rows row_lo and row_lo + 8 (see flash_sm90.cuh for the
  // fragment layout). Their row scales load before the mainloop begins.
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int row_lo = q0 + warp * 16 + (lane >> 2);
  const int qc = (lane & 3) * 2;
  const float* qs_h = qs + (size_t)bh * S;
  const QK qk{nullptr, S, (bh * S) & 3, row_lo < S ? qs_h[row_lo] : 0.f,
              row_lo + 8 < S ? qs_h[row_lo + 8] : 0.f};
  const unsigned char* sQw = sQ + wg * 64 * 128;  // this warpgroup's 64 rows
  const TileMask<HK> mask = TileMask<HK>::make(g, q0, 0, q0 + HQ <= S, S);
  const int2 vis_lo = visible_keys(g, row_lo), vis_hi = visible_keys(g, row_lo + 8);
  float o[ML::NO];
#pragma unroll
  for (int i = 0; i < ML::NO; ++i) o[i] = 0.f;
  RowState rs;
  uint32_t pa[HK / 4];  // P in bf16: the A fragments of the tile's P.V
  int acc[HK / 2];      // the tile's s32 sums
  if (n > 0) {
    ML::begin(acc, ring, sQw, q_full, 0);
    ML::rest(o, rs, acc, pa, ring, sQw, 0, t0, t1, mask, score_mul, vis_lo, vis_hi, qc, lane, qk);
  }
  store_out_bf16<ML::NO>(o, rs, out + (size_t)bh * S * D, D, row_lo, S, qc);
}

// A [heads, rows, d] int8 tensor map with a 128 x `box_rows` x 1 box.
bool int8_head_map(CUtensorMap* map, const void* base, int heads, int rows, int d,
                   int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d, (cuuint64_t)rows * d};
  const cuuint32_t box[3] = {128, (cuuint32_t)box_rows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, base, 3, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// The [n] f32 scales as one dimension, a box of `box` scales, no swizzle.
bool scale_map(CUtensorMap* map, const void* base, int n, int box) {
  const cuuint64_t dims[1] = {(cuuint64_t)n};
  const cuuint64_t strides[1] = {(cuuint64_t)n * sizeof(float)};  // not read at rank 1
  const cuuint32_t boxes[1] = {(cuuint32_t)box};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, base, 1, dims, strides, boxes,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

template <int D, int HK, int STAGES>
cudaError_t launch(const void* q8, const void* k8, const void* qs, const void* ks, const void* v,
                   void* out, int bh, Segments g, float score_mul, cudaStream_t stream) {
  CUtensorMap mq, mk, mks, mv;
  if (!int8_head_map(&mq, q8, bh, g.seq_len, D, HQ) ||
      !int8_head_map(&mk, k8, bh, g.seq_len, D, HK) ||
      !scale_map(&mks, ks, bh * g.seq_len, Int8QK<D, HK>::KS_BOX) ||
      !head_map(&mv, v, bh, g.seq_len, D, HK)) {
    return cudaErrorInvalidValue;
  }
  using Ring = KvRing<D, D, HK, STAGES, Int8QK<D, HK>>;
  constexpr size_t smem = 1024 + (size_t)(D / 128) * HQ * 128 + Ring::bytes + sizeof(uint64_t);
  static_assert(smem <= 232448, "shared memory of one block on sm_90");
  auto kernel = flash_saliency_int8_sm90_kernel<D, HK, STAGES>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.seq_len + HQ - 1) / HQ, bh);
  kernel<<<grid, THREADS, smem, stream>>>(mq, mk, mks, mv, static_cast<const float*>(qs),
                                          static_cast<__nv_bfloat16*>(out), g, score_mul);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q8, k8: [B, H, S, 128] int8 and qs, ks: [B, H, S] f32 from
// ca_flash_saliency_int8_prepass (csrc/flash_saliency_int8.cu); v, out:
// [B, H, S, 128] bf16; every buffer contiguous and 16-byte aligned.
// score_mul = 1 when the pre-pass roped and scaled q, else log2(e) /
// sqrt(D). Head dim 128 only. Returns a cudaError_t.
int ca_flash_saliency_int8_sm90(const void* q8, const void* k8, const void* qs, const void* ks,
                                const void* v, void* out, int batch, int heads, int seq_len,
                                int head_dim, int txt_len, int img_len, int concept_len,
                                int cross, int self_attn, float score_mul, void* stream) {
  if (head_dim != I8_D) return cudaErrorInvalidValue;
  const Segments g = make_segments(seq_len, txt_len, img_len, concept_len, cross, self_attn);
  return launch<I8_D, I8_HK, I8_STAGES>(q8, k8, qs, ks, v, out, batch * heads, g, score_mul,
                                        static_cast<cudaStream_t>(stream));
}

const char* ca_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
