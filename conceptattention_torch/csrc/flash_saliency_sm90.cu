// Fused dual-pass concept flash attention redesigned for Hopper (sm_90a):
// TMA, an mbarrier ring, warp specialisation and wgmma. bf16 in and out.
//
// Replaces, in the JAX package's kernels/flash_saliency.py, K1
// fused_concept_flash_attention (Pallas body _flash_kernel) at head dims 64,
// 128 and 512:
//   D = 128, the flux double blocks (S = 4355 with concepts) and single
//     blocks (S = 4352);
//   D = 64, the CogVideoX-5b blocks (B = 2, 48 heads, S = 18002);
//   D = 512, the flux VAE decoder's mid-attention (one head, S = 16384, no
//     RoPE, no concepts).
// Head dim 32 stays on csrc/flash_saliency.cu.
//
// The function is K1's (flash_saliency.cu), with the same rounding points:
//   q in txt|img -> k in txt|img; q in concept -> k in img (cross) and k in
//   concept (self_attn); pad rows see nothing and come out as exact zeros;
//   roped q pre-scaled by log2(e)/sqrt(D) in f32 and rounded to bf16, roped
//   k rounded to bf16 (without tables the f32 scores are scaled instead,
//   fused into the exp2's argument); f32 scores, an exp2 online softmax, P
//   rounded to bf16, f32 P.V.
//
// What bounds it on an H100: ~4 S^2 D flops per head against ~8 S D bytes,
// 1000-4500 flops per byte at these shapes: the tensor cores. The design:
//   - ca_rope_qk_rows_bf16, a pre-pass, ropes, pre-scales and rounds every q
//     and k row once per call into bf16 scratch (flash_saliency.cu rotates
//     each key row once per query tile, 141 times at S = 18002, from f32
//     tables read out of L2);
//   - the main kernel takes a 128-query tile and a DC-column chunk of the
//     output per block: one thread of a producer warpgroup issues every
//     copy, which loads Q once and streams HK-key K tiles and their V chunk by TMA
//     (128-byte swizzle, zero fill past S) into a STAGES-deep mbarrier ring,
//     skipping the key tiles the segment mask leaves empty; two consumer
//     warpgroups of 64 query rows each (see HQ for their registers);
//   - S = Q K^T is wgmma m64nHKk16 with both operands in shared memory; the
//     online softmax runs on the accumulator registers (each thread holds two
//     rows; a quad of lanes shares a row), masking per element only in tiles
//     tile_full rejects, with the m64 fragment's row and column mapping;
//   - O += P V is wgmma with P from registers (the f32 score fragment packed
//     to bf16 is the A fragment of the product) and V from shared memory read
//     N-major (the transpose bit);
//   - K and V have their own "full" and "empty" barriers: Q K^T starts
//     before V lands, and a K slot is refilled as soon as its scores are
//     taken, while its V is still being read;
//   - every branch between a wgmma issue and its wait is uniform over the
//     block (the key-tile range, the mask decision), and the role index
//     comes from a warp shuffle: ptxas serialises wgmma in a divergent path.
//
// The instances (<D, DC, HK, STAGES, schedule>, ca_flash_saliency_sm90_bf16):
//   D = 128: <128, 128, 128, 2, in order>, the flux DiT blocks' kernel;
//   D = 64: the exponentials cost as much as the products (B H S^2 = 3.1e10
//     exp2 at 16 a clock per SM is ~8 ms, as the tensor cores' 7.95 ms), so
//     the softmax has to run beside the products: schedule "overlap" issues
//     tile j+1's Q K^T and tile j's P.V together and runs tile j+1's softmax
//     while P.V is in flight (one warpgroup holds o[32], s[64] and P[32]).
//     <64, 64, 128, 4, overlap>;
//   D = 512: a 64 x 512 f32 output would take 256 registers a thread, and a
//     consumer gets 168, so the output's columns are split in four 128-column
//     chunks (blockIdx.z), each recomputing Q K^T over all 512 channels
//     (1375 of 550 GFLOP at the VAE shape; two 256-column chunks need 128
//     output registers and more than the 168, and ptxas spills them and
//     serialises their wgmma). Q (128 rows x 512) takes 128 KB of shared
//     memory, so the key tiles are 64 keys and the ring one stage deep:
//     <512, 128, 64, 1, in order>.
// Not yet done: a TMA store of the output, a persistent grid, multicast of
// K and V across a cluster (the D = 512 instance streams 20 MB a block from
// L2).

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace hopper;

// Two consumer warpgroups (64 query rows each) and one producer warpgroup.
// Each SM sub-partition holds 16384 registers and one warp of every
// warpgroup, so ptxas compiles the kernel to at most 168 registers a thread.
// setmaxnreg, which moves registers from one warpgroup to another at run
// time, does not raise that budget (a consumer that needs more spills and
// has its wgmma serialised all the same), so the kernel does without it.
constexpr int HQ = 128;                        // query rows per block
constexpr int CONSUMERS = 256, THREADS = 384;  // two consumer warpgroups + the producer's

// Consumer schedules, fixed per head dim (ca_flash_saliency_sm90_bf16).
constexpr int IN_ORDER = 0;  // scores, softmax, P.V of one tile, then the next tile
constexpr int OVERLAP = 1;   // tile j+1's scores and softmax beside tile j's P.V

template <int D, int DC, int HK, int STAGES>
struct Sm90Layout {
  static_assert(D % 64 == 0 && (DC == 64 || DC == 128) && D % DC == 0,
                "whole 128-byte swizzle atoms; a 64- or 128-column output chunk");
  static constexpr int ATOMS = D / 64, V_ATOMS = DC / 64;
  static constexpr uint32_t Q_ATOM = HQ * 128, KV_ATOM = HK * 128;  // bytes
  static constexpr uint32_t Q_BYTES = ATOMS * Q_ATOM, K_BYTES = ATOMS * KV_ATOM,
                            V_BYTES = V_ATOMS * KV_ATOM;
  static constexpr size_t bytes = 1024 + Q_BYTES + (size_t)STAGES * (K_BYTES + V_BYTES) +
                                  sizeof(uint64_t) * (1 + 4 * STAGES);
};

// One thread per 8 channels of one position of one batch row, looping over
// the heads, so each table entry is read once; blockIdx.y picks q (0) or k
// (1). The same rotation as flash_common.cuh's rotate8, each product and sum
// rounded on its own (no FMA), so the rows equal rope_qk_rows_plain's bit for
// bit.
template <int D>
__global__ void __launch_bounds__(256)
rope_rows_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const float* __restrict__ rope_cos, const float* __restrict__ rope_sin,
                 __nv_bfloat16* __restrict__ q_out, __nv_bfloat16* __restrict__ k_out,
                 int positions, int heads, int seq_len, float scale) {
  constexpr int TPR = D / 8;
  constexpr int RPB = 256 / TPR;
  const bool is_k = blockIdx.y == 1;
  const int pos = blockIdx.x * RPB + threadIdx.x / TPR;  // b * S + s
  if (pos >= positions) return;
  const int c = (threadIdx.x % TPR) * 8;
  const int b = pos / seq_len, s = pos % seq_len;
  const Rot8 r = load_rot8(rope_cos + (size_t)pos * D + c, rope_sin + (size_t)pos * D + c);
  const float mul = is_k ? 1.f : scale;
  const __nv_bfloat16* src = (is_k ? k : q) + (((size_t)b * heads * seq_len + s) * D + c);
  __nv_bfloat16* dst = (is_k ? k_out : q_out) + (((size_t)b * heads * seq_len + s) * D + c);
#pragma unroll 4
  for (int h = 0; h < heads; ++h) {
    const size_t off = (size_t)h * seq_len * D;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + off);
    const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw);
    uint4 y;
    uint32_t* yv = reinterpret_cast<uint32_t*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = __bfloat162float(xv[i].x), bb = __bfloat162float(xv[i].y);
      float y0 = __fadd_rn(__fmul_rn(a, r.c[2 * i]), __fmul_rn(bb, r.s[2 * i]));
      float y1 = __fadd_rn(__fmul_rn(bb, r.c[2 * i + 1]), __fmul_rn(a, r.s[2 * i + 1]));
      if (is_k) {
        yv[i] = pack_bf16(y0, y1);
      } else {  // roped q is pre-scaled in f32 before it is rounded
        yv[i] = pack_bf16(__fmul_rn(y0, mul), __fmul_rn(y1, mul));
      }
    }
    *reinterpret_cast<uint4*>(dst + off) = y;
  }
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A wgmma descriptor the compiler must recompute where it is used: without
// this it hoists every k-step's descriptors of a loop-invariant tile (all 64
// of the D = 512 instance's Q.K^T, 128 registers) out of the key loop.
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}

// S = Q K^T for one warpgroup's 64 rows and an HK-key tile (both operands
// K-major in shared memory, D / 64 atoms each, Q's of HQ rows), committed as
// one group.
template <int D, int HK>
__device__ __forceinline__ void issue_qk(float (&s)[HK / 2], const unsigned char* sQw,
                                         const unsigned char* sKs) {
  constexpr uint32_t Q_ATOM = HQ * 128, K_ATOM = HK * 128;
  // Each k-step's descriptor is the tile's plus its byte offset / 16 (the
  // start-address field).
  const uint64_t qd = opaque(desc_sw128(sQw, 16, 1024)), kd = opaque(desc_sw128(sKs, 16, 1024));
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t da = qd + (((kk / 4) * Q_ATOM + off) >> 4);
    const uint64_t db = kd + (((kk / 4) * K_ATOM + off) >> 4);
    if constexpr (HK == 128) {
      wgmma_m64n128k16_ss<0>(s, da, db, kk > 0);
    } else {
      wgmma_m64n64k16_ss<0>(s, da, db, kk > 0);
    }
  }
  wgmma_commit();
}

// O += P V over one HK-key tile: P from registers, V N-major from shared
// memory (each 64-column atom of the DC-column chunk an HK-key x 128-byte
// box), committed as one group.
template <int DC, int HK>
__device__ __forceinline__ void issue_pv(float (&o)[DC / 2], const uint32_t (&pa)[HK / 4],
                                         const unsigned char* sVs) {
  const uint64_t vd = opaque(desc_sw128(sVs, HK * 128, 1024));
#pragma unroll
  for (int t = 0; t < HK / 16; ++t) {
    const uint32_t a[4] = {pa[4 * t], pa[4 * t + 1], pa[4 * t + 2], pa[4 * t + 3]};
    const uint64_t db = vd + t * (2048 >> 4);
    if constexpr (DC == 128) {
      wgmma_m64n128k16_rs<1>(o, a, db);
    } else {
      wgmma_m64n64k16_rs<1>(o, a, db);
    }
  }
  wgmma_commit();
}

// The keys query row qi may see, as one run [x, y): the segment rule gives
// a joint row [0, joint_end), a concept row its img keys (cross) and its
// concept keys (self_attn), which are adjacent, and a pad row nothing. The
// same pairs as flash_common.cuh's allowed().
__device__ __forceinline__ int2 visible_keys(const Segments& g, int qi) {
  if (qi < g.joint_end) return make_int2(0, g.joint_end);
  if (qi >= g.concept_end || !(g.cross || g.self_attn)) return make_int2(0, 0);
  return make_int2(g.cross ? g.txt_len : g.joint_end, g.self_attn ? g.concept_end : g.joint_end);
}

// The running softmax state of a thread's two rows (maxima in scaled units).
struct RowState {
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
};

// The online softmax of one score tile in place: mask (only where the tile
// is not wholly visible to the block), exp2 of score * score_mul against the
// running max (one FMA: the maximum of the raw scores, scaled, is the
// maximum of the scaled ones). Returns the factors that rescale the running
// output.
template <int HK>
__device__ __forceinline__ float2 softmax_tile(float (&s)[HK / 2], RowState& st, bool full,
                                               float score_mul, int2 vis_lo, int2 vis_hi,
                                               int key0) {
  if (!full) {
#pragma unroll
    for (int i = 0; i < HK / 2; ++i) {
      const int key = key0 + 8 * (i / 4) + (i & 1);
      const int2 vis = (i & 2) ? vis_hi : vis_lo;
      if (key < vis.x || key >= vis.y) s[i] = -INFINITY;
    }
  }
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int i = 0; i < HK / 2; ++i) {
    if (i & 2) {
      mx_hi = fmaxf(mx_hi, s[i]);
    } else {
      mx_lo = fmaxf(mx_lo, s[i]);
    }
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  const float mn_lo = fmaxf(st.m_lo, mx_lo * score_mul);
  const float mn_hi = fmaxf(st.m_hi, mx_hi * score_mul);
  // A row that has seen no key yet keeps max -inf: exp2 against 0 then
  // gives exact zeros, and the (zero) running output needs no rescale.
  const float ref_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
  const float ref_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
  const float2 alpha = make_float2(fast_exp2(st.m_lo - ref_lo), fast_exp2(st.m_hi - ref_hi));
  st.m_lo = mn_lo;
  st.m_hi = mn_hi;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int i = 0; i < HK / 2; ++i) {
    const float x = fmaf(s[i], score_mul, (i & 2) ? -ref_hi : -ref_lo);
    s[i] = fast_exp2(x);
    if (i & 2) {
      sum_hi += s[i];
    } else {
      sum_lo += s[i];
    }
  }
  st.l_lo = st.l_lo * alpha.x + sum_lo;  // per-lane partial sums, reduced at the end
  st.l_hi = st.l_hi * alpha.y + sum_hi;
  return alpha;
}

// O *= alpha per row, then P = bf16(s) as the A fragments of the next P.V.
template <int NO, int HK>
__device__ __forceinline__ void rescale_and_pack(float (&o)[NO], float2 alpha,
                                                 const float (&s)[HK / 2],
                                                 uint32_t (&pa)[HK / 4]) {
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] *= (i & 2) ? alpha.y : alpha.x;
#pragma unroll
  for (int i = 0; i < HK / 4; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// q, k (roped and q pre-scaled, or raw with score_mul = scale), v: [B*H, S,
// D] bf16 through 3D tensor maps (box 64 x HQ or HK rows x 1 head); out:
// [B*H, S, D] bf16. Block (query tile, b*h, DC-column chunk). Warpgroups 0
// and 1 consume; warpgroup 2 produces, one thread issuing every copy. Every
// branch around the wgmma issues and waits is uniform over the block, so
// nothing serialises them.
template <int D, int DC, int HK, int STAGES, int SCHED>
__global__ void __launch_bounds__(THREADS, 1)
flash_saliency_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           __nv_bfloat16* __restrict__ out, Segments g, float score_mul) {
  using L = Sm90Layout<D, DC, HK, STAGES>;
  constexpr int NO = DC / 2;  // f32 output registers per thread (m64nDC)
  static_assert(SCHED == IN_ORDER || STAGES >= 2, "the overlap keeps two tiles in flight");

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);
  unsigned char* sK = sQ + L::Q_BYTES;              // [STAGES][ATOMS][HK rows][128 B]
  unsigned char* sV = sK + STAGES * L::K_BYTES;     // [STAGES][V_ATOMS][HK rows][128 B]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + STAGES * L::V_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  const int lane = threadIdx.x & 31;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform role
  const int q0 = blockIdx.x * HQ, bh = blockIdx.y, c0 = blockIdx.z * DC;
  const int S = g.seq_len;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_empty + s, CONSUMERS / 32);
      mbar_init(v_empty + s, CONSUMERS / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // The key tiles any row of the block can see: one run [t0, t1) (the
  // segment rule makes the run contiguous; a tile inside it that the mask
  // empties would only cost time).
  int t0 = 0, t1 = 0;
  for (int t = (S + HK - 1) / HK - 1; t >= 0; --t) {
    if (tile_reachable(g, q0, HQ, t * HK, HK)) {
      t0 = t;
      if (t1 == 0) t1 = t + 1;
    }
  }

  if (wg == CONSUMERS / 128) {  // the producer warpgroup
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int a = 0; a < L::ATOMS; ++a) {
        tma_load_3d(sQ + a * L::Q_ATOM, &map_q, q_full, a * 64, q0, bh);
      }
      for (int t = t0; t < t1; ++t) {
        const int it = t - t0, st = it % STAGES;
        const uint32_t free_ph = ((it / STAGES) & 1) ^ 1;
        mbar_wait(k_empty + st, free_ph);
        mbar_expect_tx(k_full + st, L::K_BYTES);
        for (int a = 0; a < L::ATOMS; ++a) {
          tma_load_3d(sK + st * L::K_BYTES + a * L::KV_ATOM, &map_k, k_full + st, a * 64, t * HK,
                      bh);
        }
        mbar_wait(v_empty + st, free_ph);
        mbar_expect_tx(v_full + st, L::V_BYTES);
        for (int a = 0; a < L::V_ATOMS; ++a) {
          tma_load_3d(sV + st * L::V_BYTES + a * L::KV_ATOM, &map_v, v_full + st, c0 + a * 64,
                      t * HK, bh);
        }
      }
    }
    return;
  }

  // Consumers. Thread (warpgroup wg, lane) of warp w holds rows row_lo and
  // row_lo + 8; its score element i sits at row (i & 2 ? hi : lo), key
  // k0 + 8 * (i / 4) + qc + (i & 1), as its output element i at column
  // c0 + 8 * (i / 4) + qc + (i & 1).
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int row_lo = q0 + warp * 16 + (lane >> 2);
  const int qc = (lane & 3) * 2;
  const unsigned char* sQw = sQ + wg * 64 * 128;  // this warpgroup's 64 rows in each atom
  const int2 vis_lo = visible_keys(g, row_lo), vis_hi = visible_keys(g, row_lo + 8);
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  RowState rs;
  uint32_t pa[HK / 4];  // P in bf16: the A fragments of the tile's P.V
  float sc[HK / 2];     // the scores of the tile in hand

  mbar_wait(q_full, 0);
  if constexpr (SCHED == IN_ORDER) {
    for (int t = t0; t < t1; ++t) {
      const int it = t - t0, st = it % STAGES;
      const uint32_t ph = (it / STAGES) & 1;
      mbar_wait(k_full + st, ph);
      wgmma_fence();
      issue_qk<D, HK>(sc, sQw, sK + st * L::K_BYTES);
      wgmma_wait<0>();
      fence_regs(sc);
      warp_arrive(k_empty + st, lane);  // the K slot refills while this tile's V is read
      const float2 alpha = softmax_tile<HK>(sc, rs, tile_full(g, q0, HQ, t * HK, HK), score_mul,
                                            vis_lo, vis_hi, t * HK + qc);
      rescale_and_pack<NO, HK>(o, alpha, sc, pa);
      mbar_wait(v_full + st, ph);
      wgmma_fence();
      issue_pv<DC, HK>(o, pa, sV + st * L::V_BYTES);
      wgmma_wait<0>();
      fence_regs(o);
      warp_arrive(v_empty + st, lane);
    }
  } else {
    // Tile t0's scores and softmax alone; then each step issues tile j's
    // Q K^T and tile j-1's P.V as two groups, waits for the first, runs
    // tile j's softmax while the P.V is in flight, waits for the second and
    // rescales. pa (tile j-1's P, read by the P.V in flight) and o are not
    // touched between the issue and the second wait.
    const int n = t1 - t0;  // uniform over the block
    if (n > 0) {
      mbar_wait(k_full, 0);
      wgmma_fence();
      issue_qk<D, HK>(sc, sQw, sK);
      wgmma_wait<0>();
      fence_regs(sc);
      warp_arrive(k_empty, lane);
      const float2 alpha0 = softmax_tile<HK>(sc, rs, tile_full(g, q0, HQ, t0 * HK, HK),
                                             score_mul, vis_lo, vis_hi, t0 * HK + qc);
      rescale_and_pack<NO, HK>(o, alpha0, sc, pa);
      for (int it = 1; it < n; ++it) {
        const int st = it % STAGES, pst = (it - 1) % STAGES;
        mbar_wait(k_full + st, (it / STAGES) & 1);
        mbar_wait(v_full + pst, ((it - 1) / STAGES) & 1);
        wgmma_fence();
        issue_qk<D, HK>(sc, sQw, sK + st * L::K_BYTES);
        issue_pv<DC, HK>(o, pa, sV + pst * L::V_BYTES);
        wgmma_wait<1>();
        fence_regs(sc);
        warp_arrive(k_empty + st, lane);
        const int t = t0 + it;
        const float2 alpha = softmax_tile<HK>(sc, rs, tile_full(g, q0, HQ, t * HK, HK),
                                              score_mul, vis_lo, vis_hi, t * HK + qc);
        wgmma_wait<0>();
        fence_regs(o);
        warp_arrive(v_empty + pst, lane);
        rescale_and_pack<NO, HK>(o, alpha, sc, pa);
      }
      const int lst = (n - 1) % STAGES;
      mbar_wait(v_full + lst, ((n - 1) / STAGES) & 1);
      wgmma_fence();
      issue_pv<DC, HK>(o, pa, sV + lst * L::V_BYTES);
      wgmma_wait<0>();
      fence_regs(o);
      warp_arrive(v_empty + lst, lane);
    }
  }
  float l_lo = rs.l_lo, l_hi = rs.l_hi;
  const int row_hi = row_lo + 8;

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = l_lo == 0.f ? 0.f : 1.f / l_lo;  // empty rows: exact zeros
  const float inv_hi = l_hi == 0.f ? 0.f : 1.f / l_hi;
  __nv_bfloat16* out_h = out + (size_t)bh * S * D + c0;
#pragma unroll
  for (int j = 0; j < DC / 8; ++j) {
    const int c = j * 8 + qc;
    if (row_lo < S) {
      *reinterpret_cast<uint32_t*>(out_h + (size_t)row_lo * D + c) =
          pack_bf16(o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo);
    }
    if (row_hi < S) {
      *reinterpret_cast<uint32_t*>(out_h + (size_t)row_hi * D + c) =
          pack_bf16(o[4 * j + 2] * inv_hi, o[4 * j + 3] * inv_hi);
    }
  }
}

// A [B*H, S, D] bf16 tensor map with a 64 x `rows` box.
bool head_map(CUtensorMap* map, const void* base, int bh, int seq_len, int d, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)seq_len, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)seq_len * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  return encode_bf16_map(map, base, 3, dims, strides, box);
}

template <int D, int DC, int HK, int STAGES, int SCHED>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh, Segments g,
                   float score_mul, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!head_map(&mq, q, bh, g.seq_len, D, HQ) || !head_map(&mk, k, bh, g.seq_len, D, HK) ||
      !head_map(&mv, v, bh, g.seq_len, D, HK)) {
    return cudaErrorInvalidValue;
  }
  constexpr size_t smem = Sm90Layout<D, DC, HK, STAGES>::bytes;
  static_assert(smem <= 232448, "shared memory of one block on sm_90");
  auto kernel = flash_saliency_sm90_kernel<D, DC, HK, STAGES, SCHED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.seq_len + HQ - 1) / HQ, bh, D / DC);
  kernel<<<grid, THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), g, score_mul);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_rope(const void* q, const void* k, const void* rope_cos, const void* rope_sin,
                        void* q_out, void* k_out, int batch, int heads, int seq_len, float scale,
                        cudaStream_t stream) {
  constexpr int RPB = 256 / (D / 8);
  const int positions = batch * seq_len;
  const dim3 grid((positions + RPB - 1) / RPB, 2);
  rope_rows_kernel<D><<<grid, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const float*>(rope_cos), static_cast<const float*>(rope_sin),
      static_cast<__nv_bfloat16*>(q_out), static_cast<__nv_bfloat16*>(k_out), positions, heads,
      seq_len, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k -> q_out, k_out: [B, H, S, D] bf16, D in {64, 128, 512}; rope_cos /
// rope_sin: [B, S, D] f32. q_out = bf16(rope(q) * scale), k_out =
// bf16(rope(k)). Returns a cudaError_t.
int ca_rope_qk_rows_bf16(const void* q, const void* k, const void* rope_cos, const void* rope_sin,
                         void* q_out, void* k_out, int batch, int heads, int seq_len,
                         int head_dim, float scale, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return launch_rope<64>(q, k, rope_cos, rope_sin, q_out, k_out, batch, heads, seq_len,
                             scale, s);
    case 128:
      return launch_rope<128>(q, k, rope_cos, rope_sin, q_out, k_out, batch, heads, seq_len,
                              scale, s);
    case 512:
      return launch_rope<512>(q, k, rope_cos, rope_sin, q_out, k_out, batch, heads, seq_len,
                              scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// q, k, v, out: [B, H, S, D] bf16, contiguous, 16-byte aligned; q and k
// roped (q pre-scaled, score_mul = 1) or raw (score_mul = log2(e)/sqrt(D)).
// Head dims 64, 128 and 512. Returns a cudaError_t.
int ca_flash_saliency_sm90_bf16(const void* q, const void* k, const void* v, void* out,
                                int batch, int heads, int seq_len, int head_dim, int txt_len,
                                int img_len, int concept_len, int cross, int self_attn,
                                float score_mul, void* stream) {
  const Segments g = make_segments(seq_len, txt_len, img_len, concept_len, cross, self_attn);
  const int bh = batch * heads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch<64, 64, 128, 4, OVERLAP>(q, k, v, out, bh, g, score_mul, s);
  if (head_dim == 128) return launch<128, 128, 128, 2, IN_ORDER>(q, k, v, out, bh, g, score_mul, s);
  if (head_dim == 512) return launch<512, 128, 64, 1, IN_ORDER>(q, k, v, out, bh, g, score_mul, s);
  return cudaErrorInvalidValue;
}

const char* ca_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
