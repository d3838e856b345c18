// The Hopper (sm_90a) attention mainloop shared by the flash-saliency kernels
// (csrc/flash_saliency_sm90.cu: K1, and K3 with two heads per block;
// csrc/flash_saliency_int8_sm90.cu: K1b, int8 scores) and the ring step
// kernel (csrc/ring_attention_sm90.cu: K4).
//
// A block takes HQ = 128 query rows. One thread of a producer warpgroup
// issues every TMA copy: the Q tile, then HK-key K tiles and their DC-column
// V chunk into a STAGES-deep mbarrier ring (KvRing), with separate "full"
// and "empty" barriers for K and V, so Q K^T starts before V lands and a K
// slot refills as soon as its scores are taken. Two consumer warpgroups of
// 64 rows each run the Mainloop:
//   - S = Q K^T is wgmma m64nHKk16 with both operands in shared memory
//     (128-byte swizzled, K-major);
//   - a QK parameter of KvRing and Mainloop says what Q K^T reads and how
//     its sums become scores: Bf16QK below (K1, K3, K4: the f32
//     accumulators are the scores), or K1b's int8 rows, whose s32 sums take
//     the key scales that land in the ring beside each K tile and whose row
//     scales ride in the softmax's multiplier of each row;
//   - the online softmax runs on the accumulator registers (each thread
//     holds two rows; a quad of lanes shares a row), masking per element
//     only in tiles TileMask::full rejects, exp2 of score * score_mul
//     against the running max (one FMA);
//   - O += P V is wgmma with P from registers (the f32 score fragment
//     packed to bf16 is the A fragment) and V read N-major (transpose bit).
// The key tiles a block visits are one run [t0, t1); `it0` numbers the run's
// first tile in the ring, so a block that walks several runs through one
// ring (K3's two heads) keeps the ring's stage and phase going across them.
// Mainloop::begin waits for Q and the run's first K tile and issues its
// Q K^T; Mainloop::rest takes the scores and sweeps the run. Nothing runs
// between the two: with K3's store of one head's output (and the reset of
// its accumulators) placed there, beside the next head's first Q K^T,
// ptxas serialised every wgmma of the kernel ("non wgmma instructions
// defining accumulator registers of a wgmma between start and end of the
// pipeline stage").
//
// Consumer schedules, fixed per kernel instance:
//   IN_ORDER: scores, softmax, P.V of one tile, then the next tile;
//   OVERLAP: tile j+1's Q K^T and softmax beside tile j's P.V (needs
//     STAGES >= 2; one warpgroup holds o[DC/2], s[HK/2] and P[HK/4]);
//   PINGPONG: IN_ORDER's steps, the two consumer warpgroups taking turns
//     at the tensor cores (named barriers 1 and 2): in its turn a
//     warpgroup issues tile j-1's P.V, waits for it and issues tile j's
//     Q K^T, then hands the turn over, so one warpgroup's softmax runs
//     while the other's products do;
//   OVERLAP_WIDE: OVERLAP on the registers the producer gives up (below),
//     with the output's rescale by tile j+1's factors moved from the end of
//     that step (after tile j's P.V lands) into the next step, between the
//     issue of tile j+2's Q K^T and that of tile j+1's P.V: it runs while
//     the Q K^T does, and a step ends with packing P alone. No turns: the
//     two warpgroups' overlapped steps interleave at the tensor cores by
//     themselves (PINGPONG's turns on top of it timed the same).
//
// Registers: a block of three warpgroups compiles to at most 168 registers
// a thread (each SM sub-partition holds 16384 and one warp of every
// warpgroup). OVERLAP at head dim 128 needs more (o[64], s[HK/2], P[HK/4]):
// under 168 ptxas spills it and serialises its wgmma. OVERLAP_WIDE's kernel
// moves registers with setmaxnreg: the producer warpgroup drops to
// PRODUCER_REGS and each consumer warpgroup rises to CONSUMER_REGS, and
// ptxas allocates the consumers' path to that budget, provided no trap
// lies on it: its waits spin without mbar_wait's watchdog (mbar_wait_spin),
// while the producer's keep it. Every branch between a wgmma issue and its
// wait is uniform over the block (the tile run, the mask decision) and row
// guards on stores are predicates, not branches: ptxas serialises wgmma in
// a divergent path.
#pragma once

#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int HQ = 128;                        // query rows per block
constexpr int CONSUMERS = 256, THREADS = 384;  // two consumer warpgroups + the producer's
constexpr int IN_ORDER = 0, OVERLAP = 1, PINGPONG = 2, OVERLAP_WIDE = 3;  // consumer schedules
// OVERLAP_WIDE's register budgets (setmaxnreg): 128 x (24 + 2 x 240) = 64,512
// of the SM's 65,536.
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

template <int D, int HK>
struct Bf16QK;

// The K / V ring in shared memory: [STAGES][QK::ATOMS][HK rows][128 B] of K,
// [STAGES][DC/64 atoms][HK rows][128 B] of V, [STAGES][QK::EXTRA_STRIDE] of
// what lands beside each K tile (nothing for bf16), then its barriers.
template <int D, int DC, int HK, int STAGES, class QK = Bf16QK<D, HK>>
struct KvRing {
  static_assert(D % 64 == 0 && (DC == 64 || DC == 128) && D % DC == 0,
                "whole 128-byte swizzle atoms; a 64- or 128-column output chunk");
  static constexpr int ATOMS = QK::ATOMS, V_ATOMS = DC / 64;
  static constexpr uint32_t KV_ATOM = HK * 128;  // bytes
  static constexpr uint32_t K_BYTES = ATOMS * KV_ATOM, V_BYTES = V_ATOMS * KV_ATOM;
  static constexpr uint32_t X_BYTES = QK::EXTRA_STRIDE;
  static constexpr size_t bytes =
      (size_t)STAGES * (K_BYTES + V_BYTES + X_BYTES) + sizeof(uint64_t) * 4 * STAGES;

  static constexpr uint32_t V_OFF = STAGES * K_BYTES, X_OFF = STAGES * (K_BYTES + V_BYTES);
  static constexpr uint32_t BAR_OFF = STAGES * (K_BYTES + V_BYTES + X_BYTES);

  // Everything at constant offsets from one base (1024-byte aligned), so
  // the mainloop keeps one address live, not one per array.
  unsigned char* base;

  __device__ __forceinline__ unsigned char* k_tile(int st) const { return base + st * K_BYTES; }
  __device__ __forceinline__ unsigned char* v_tile(int st) const {
    return base + V_OFF + st * V_BYTES;
  }
  __device__ __forceinline__ unsigned char* k_extra(int st) const {
    return base + X_OFF + st * X_BYTES;
  }
  __device__ __forceinline__ uint64_t* bar(int i) const {
    return reinterpret_cast<uint64_t*>(base + BAR_OFF) + i;
  }
  __device__ __forceinline__ uint64_t* k_full(int st) const { return bar(st); }
  __device__ __forceinline__ uint64_t* v_full(int st) const { return bar(STAGES + st); }
  __device__ __forceinline__ uint64_t* k_empty(int st) const { return bar(2 * STAGES + st); }
  __device__ __forceinline__ uint64_t* v_empty(int st) const { return bar(3 * STAGES + st); }

  // The ring's end: the first byte after its barriers.
  __device__ __forceinline__ unsigned char* end() const {
    return reinterpret_cast<unsigned char*>(bar(4 * STAGES));
  }

  // One thread, before the block's first __syncthreads.
  __device__ __forceinline__ void init() const {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), CONSUMERS / 32);
      mbar_init(v_empty(s), CONSUMERS / 32);
    }
  }

  // The producer thread: the K tiles [t0, t1) of head `bh` (3D maps over
  // [heads, rows, D], box QK::ATOM_COLS x HK x 1) with what lands beside
  // them, and their V chunk from column c0, the run's first tile at ring
  // position it0.
  __device__ __forceinline__ void produce(const CUtensorMap* map_k, const CUtensorMap* map_v,
                                          int it0, int t0, int t1, int bh, int c0,
                                          const QK& qk = QK()) const {
    for (int t = t0; t < t1; ++t) {
      const int it = it0 + t - t0, st = it % STAGES;
      const uint32_t free_ph = ((it / STAGES) & 1) ^ 1;
      mbar_wait(k_empty(st), free_ph);
      mbar_expect_tx(k_full(st), K_BYTES + QK::EXTRA_BYTES);
      for (int a = 0; a < ATOMS; ++a) {
        tma_load_3d(k_tile(st) + a * KV_ATOM, map_k, k_full(st), a * QK::ATOM_COLS, t * HK, bh);
      }
      qk.produce_extra(k_extra(st), k_full(st), t, bh);
      mbar_wait(v_empty(st), free_ph);
      mbar_expect_tx(v_full(st), V_BYTES);
      for (int a = 0; a < V_ATOMS; ++a) {
        tma_load_3d(v_tile(st) + a * KV_ATOM, map_v, v_full(st), c0 + a * 64, t * HK, bh);
      }
    }
  }
};

// The producer thread: a Q tile (HQ rows from q0 of head bh, ATOMS atoms of
// ATOM_COLS elements) into sQ, announced on `bar`.
template <int D, int ATOMS = D / 64, int ATOM_COLS = 64>
__device__ __forceinline__ void produce_q(unsigned char* sQ, const CUtensorMap* map_q,
                                          uint64_t* bar, int q0, int bh) {
  mbar_expect_tx(bar, ATOMS * HQ * 128);
  for (int a = 0; a < ATOMS; ++a) {
    tma_load_3d(sQ + a * HQ * 128, map_q, bar, a * ATOM_COLS, q0, bh);
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
    if constexpr (HK == 192) {
      wgmma_m64n192k16_ss<0>(s, da, db, kk > 0);
    } else if constexpr (HK == 128) {
      wgmma_m64n128k16_ss<0>(s, da, db, kk > 0);
    } else {
      wgmma_m64n64k16_ss<0>(s, da, db, kk > 0);
    }
  }
  wgmma_commit();
}

// The Q K^T of K1, K3 and K4: bf16 rows of D / 64 atoms, nothing beside a
// K tile, and the f32 accumulators are the scores.
template <int D, int HK>
struct Bf16QK {
  using Acc = float;                          // the Q K^T accumulators' type
  static constexpr int ATOMS = D / 64;        // 128-byte atoms in a row of Q or K
  static constexpr int ATOM_COLS = 64;        // elements in an atom
  static constexpr uint32_t EXTRA_BYTES = 0;  // bytes that land beside each K tile
  static constexpr uint32_t EXTRA_STRIDE = 0; // their room in a ring stage (128-byte multiple)

  // The producer thread: what lands beside K tile t of head bh, announced
  // on its barrier (nothing).
  __device__ __forceinline__ void produce_extra(unsigned char*, uint64_t*, int, int) const {}

  static __device__ __forceinline__ void issue(float (&acc)[HK / 2], const unsigned char* sQw,
                                               const unsigned char* sKs) {
    issue_qk<D, HK>(acc, sQw, sKs);
  }

  // The tile's scores from its accumulators (waited for) and what landed
  // beside its K tile, read before the slot is released; `f` is room for
  // them where they are not the accumulators themselves, as here.
  __device__ __forceinline__ auto& scores(float (&acc)[HK / 2], float (&)[HK / 2],
                                          const unsigned char*, int) const {
    return acc;
  }

  // What the softmax multiplies the scores by: the caller's score_mul.
  __device__ __forceinline__ float row_mul(float score_mul) const { return score_mul; }
};

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

// Which key tiles need no per-element mask: every pair of the block's HQ
// rows (global positions from q0, all inside the block's sequence when
// q_inside) and the tile's HK keys (from global position k_base + t * HK,
// the tile inside the k_len keys the block sweeps) is visible. tile_full of
// flash_common.cuh tile by tile, folded once a block into at most two runs
// of tiles, [a0, a1) and [b0, b1), so the mainloop keeps four integers.
template <int HK>
struct TileMask {
  int a0, a1, b0, b1;

  __device__ __forceinline__ bool full(int t) const {
    return (t >= a0 && t < a1) || (t >= b0 && t < b1);
  }

  // The first tile whose keys all lie at or after global position `start`.
  static __device__ __forceinline__ int first_from(int start, int k_base) {
    return start <= k_base ? 0 : (start - k_base + HK - 1) / HK;
  }

  // One past the last tile whose keys all lie before `end` and inside k_len.
  static __device__ __forceinline__ int end_before(int end, int k_base, int k_len) {
    return min(k_len / HK, end <= k_base ? 0 : (end - k_base) / HK);
  }

  static __device__ __forceinline__ TileMask make(const Segments& g, int q0, int k_base,
                                                  bool q_inside, int k_len) {
    TileMask m{0, 0, 0, 0};
    const int q1 = q0 + HQ;
    if (!q_inside) return m;
    if (q1 <= g.joint_end) {  // joint rows: the joint keys
      m.a1 = end_before(g.joint_end, k_base, k_len);
    } else if (q0 >= g.joint_end && q1 <= g.concept_end) {  // concept rows
      if (g.cross) {
        m.a0 = first_from(g.txt_len, k_base);
        m.a1 = end_before(g.joint_end, k_base, k_len);
      }
      if (g.self_attn) {
        m.b0 = first_from(g.joint_end, k_base);
        m.b1 = end_before(g.concept_end, k_base, k_len);
      }
    }
    return m;
  }
};

// An integer the compiler must treat as unknown here: a value derived from it
// later is computed there, not kept live from an earlier use.
__device__ __forceinline__ int opaque_int(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// The running softmax state of a thread's two rows (maxima in scaled units;
// sums as per-lane partials until reduce_sums).
struct RowState {
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
};

// A score multiplier for the thread's lo and hi rows: one for both (float)
// or one a row (float2).
__device__ __forceinline__ float lo_mul(float m) { return m; }
__device__ __forceinline__ float hi_mul(float m) { return m; }
__device__ __forceinline__ float lo_mul(float2 m) { return m.x; }
__device__ __forceinline__ float hi_mul(float2 m) { return m.y; }

// The online softmax of one score tile in place: mask (only where the tile
// is not wholly visible to the block), exp2 of score * score_mul against the
// running max (one FMA: the maximum of the raw scores, scaled, is the
// maximum of the scaled ones; score_mul > 0, one for both rows or one a
// row). Returns the factors that rescale the running output. key0 is the key
// of the thread's score element 0.
template <int HK, class Mul>
__device__ __forceinline__ float2 softmax_tile(float (&s)[HK / 2], RowState& st, bool full,
                                               Mul score_mul, int2 vis_lo, int2 vis_hi,
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
  const float mn_lo = fmaxf(st.m_lo, mx_lo * lo_mul(score_mul));
  const float mn_hi = fmaxf(st.m_hi, mx_hi * hi_mul(score_mul));
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
    const float x = (i & 2) ? fmaf(s[i], hi_mul(score_mul), -ref_hi)
                            : fmaf(s[i], lo_mul(score_mul), -ref_lo);
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

// O *= alpha per row.
template <int NO>
__device__ __forceinline__ void rescale(float (&o)[NO], float2 alpha) {
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] *= (i & 2) ? alpha.y : alpha.x;
}

// P = bf16(s) as the A fragments of the next P.V.
template <int HK>
__device__ __forceinline__ void pack(const float (&s)[HK / 2], uint32_t (&pa)[HK / 4]) {
#pragma unroll
  for (int i = 0; i < HK / 4; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// O *= alpha per row, then P = bf16(s) as the A fragments of the next P.V.
template <int NO, int HK>
__device__ __forceinline__ void rescale_and_pack(float (&o)[NO], float2 alpha,
                                                 const float (&s)[HK / 2],
                                                 uint32_t (&pa)[HK / 4]) {
  rescale<NO>(o, alpha);
  pack<HK>(s, pa);
}

// The row sums of the quad (whole-row sums on every lane of the quad).
__device__ __forceinline__ float2 reduce_sums(const RowState& rs) {
  float l_lo = rs.l_lo, l_hi = rs.l_hi;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  return make_float2(l_lo, l_hi);
}

// The thread's output rows normalised and rounded to bf16: out_rows points
// at row 0, column 0 of the output chunk (row stride ld elements); rows at
// or past `rows` are not written; a row whose sum is 0 comes out as exact
// zeros. Thread (warp w, lane) holds rows row_lo and row_lo + 8 and, of
// each, columns 8 j + qc, 8 j + qc + 1.
template <int NO>
__device__ __forceinline__ void store_out_bf16(const float (&o)[NO], const RowState& rs,
                                               __nv_bfloat16* out_rows, int ld, int row_lo,
                                               int rows, int qc) {
  const float2 l = reduce_sums(rs);
  const float inv_lo = l.x == 0.f ? 0.f : 1.f / l.x;
  const float inv_hi = l.y == 0.f ? 0.f : 1.f / l.y;
  const bool ok_lo = row_lo < rows, ok_hi = row_lo + 8 < rows;
  __nv_bfloat16* lo = out_rows + (size_t)row_lo * ld + qc;
  __nv_bfloat16* hi = lo + (size_t)8 * ld;
#pragma unroll
  for (int j = 0; j < NO / 4; ++j) {
    st_global_u32_if(lo + j * 8, pack_bf16(o[4 * j] * inv_lo, o[4 * j + 1] * inv_lo), ok_lo);
    st_global_u32_if(hi + j * 8, pack_bf16(o[4 * j + 2] * inv_hi, o[4 * j + 3] * inv_hi), ok_hi);
  }
}

// PINGPONG's turns: consumer warpgroup wg takes its turn on named barrier
// 1 + wg, which the other's arrival opens, and hands it over by arriving
// on the other's.
__device__ __forceinline__ int consumer_wg() {
  return __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform
}
__device__ __forceinline__ void take_turn(int wg) { named_barrier_sync(1 + wg, CONSUMERS); }
__device__ __forceinline__ void give_turn(int wg, bool pred) {
  named_barrier_arrive_if(2 - wg, CONSUMERS, pred);
}

// The consumer side: one warpgroup's 64 rows over a run of key tiles.
template <int D, int DC, int HK, int STAGES, int SCHED, class QK = Bf16QK<D, HK>>
struct Mainloop {
  using Ring = KvRing<D, DC, HK, STAGES, QK>;
  using Acc = typename QK::Acc;
  static constexpr int NO = DC / 2;  // f32 output registers per thread (m64nDC)
  static_assert(SCHED == IN_ORDER || STAGES >= 2, "the overlap keeps two tiles in flight");
  // The kernel raises the consumers' registers (setmaxnreg), and their waits
  // spin without the watchdog.
  static constexpr bool WIDE = SCHED == OVERLAP_WIDE;

  static __device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
    if constexpr (WIDE) {
      mbar_wait_spin(bar, parity);
    } else {
      mbar_wait(bar, parity);
    }
  }

  // Waits for Q (q_bar) and the run's first K tile (ring position it0), and
  // issues its Q K^T into acc. The caller runs `rest` next.
  static __device__ __forceinline__ void begin(Acc (&acc)[HK / 2], const Ring& r,
                                               const unsigned char* sQw, uint64_t* q_bar,
                                               int it0) {
    if constexpr (SCHED == PINGPONG) {
      give_turn(consumer_wg(), consumer_wg() == 1);  // warpgroup 0 takes the first turn
      take_turn(consumer_wg());
    }
    wait_phase(q_bar, 0);
    wait_phase(r.k_full(it0 % STAGES), (it0 / STAGES) & 1);
    wgmma_fence();
    QK::issue(acc, sQw, r.k_tile(it0 % STAGES));
    if constexpr (SCHED == PINGPONG) give_turn(consumer_wg(), true);
  }

  // The run [t0, t1) (t1 > t0) from the first tile's Q K^T in flight
  // (begin): folds every tile into (o, rs). Each tile's scores are taken
  // (qk.scores) before its K slot is released.
  static __device__ __forceinline__ void rest(float (&o)[NO], RowState& rs, Acc (&acc)[HK / 2],
                                              uint32_t (&pa)[HK / 4], const Ring& r,
                                              const unsigned char* sQw, int it0, int t0, int t1,
                                              const TileMask<HK>& mask, float score_mul,
                                              int2 vis_lo, int2 vis_hi, int qc, int lane,
                                              const QK& qk = QK()) {
    const int n = t1 - t0;  // uniform over the block
    const int st0 = it0 % STAGES;
    wgmma_wait<0>();
    fence_regs(acc);
    float f0[HK / 2];
    auto& s0 = qk.scores(acc, f0, r.k_extra(st0), qc);
    warp_arrive(r.k_empty(st0), lane);  // the K slot refills while this tile's V is read
    const float2 alpha0 =
        softmax_tile<HK>(s0, rs, mask.full(t0), qk.row_mul(score_mul), vis_lo, vis_hi,
                         t0 * HK + qc);
    rescale_and_pack<NO, HK>(o, alpha0, s0, pa);
    if constexpr (SCHED == PINGPONG) {
      const int wg = consumer_wg();
      for (int j = 1; j < n; ++j) {
        const int pit = it0 + j - 1, pst = pit % STAGES, it = pit + 1, st = it % STAGES;
        const int t = t0 + j;
        take_turn(wg);
        wait_phase(r.v_full(pst), (pit / STAGES) & 1);
        wgmma_fence();
        issue_pv<DC, HK>(o, pa, r.v_tile(pst));
        wgmma_wait<0>();
        fence_regs(o);
        warp_arrive(r.v_empty(pst), lane);
        wait_phase(r.k_full(st), (it / STAGES) & 1);
        wgmma_fence();
        QK::issue(acc, sQw, r.k_tile(st));
        give_turn(wg, true);
        wgmma_wait<0>();
        fence_regs(acc);
        float f[HK / 2];
        auto& s = qk.scores(acc, f, r.k_extra(st), qc);
        warp_arrive(r.k_empty(st), lane);
        const float2 alpha =
            softmax_tile<HK>(s, rs, mask.full(t), qk.row_mul(score_mul), vis_lo, vis_hi,
                             t * HK + qc);
        rescale_and_pack<NO, HK>(o, alpha, s, pa);
      }
      const int lit = it0 + n - 1, lst = lit % STAGES;
      take_turn(wg);
      wait_phase(r.v_full(lst), (lit / STAGES) & 1);
      wgmma_fence();
      issue_pv<DC, HK>(o, pa, r.v_tile(lst));
      give_turn(wg, wg == 0);  // warpgroup 1's would open a turn no one takes
      wgmma_wait<0>();
      fence_regs(o);
      warp_arrive(r.v_empty(lst), lane);
    } else if constexpr (SCHED == IN_ORDER) {
      wait_phase(r.v_full(st0), (it0 / STAGES) & 1);
      wgmma_fence();
      issue_pv<DC, HK>(o, pa, r.v_tile(st0));
      wgmma_wait<0>();
      fence_regs(o);
      warp_arrive(r.v_empty(st0), lane);
      for (int j = 1; j < n; ++j) {
        const int it = it0 + j, st = it % STAGES, t = t0 + j;
        const uint32_t ph = (it / STAGES) & 1;
        wait_phase(r.k_full(st), ph);
        wgmma_fence();
        QK::issue(acc, sQw, r.k_tile(st));
        wgmma_wait<0>();
        fence_regs(acc);
        float f[HK / 2];
        auto& s = qk.scores(acc, f, r.k_extra(st), qc);
        warp_arrive(r.k_empty(st), lane);
        const float2 alpha =
            softmax_tile<HK>(s, rs, mask.full(t), qk.row_mul(score_mul), vis_lo, vis_hi,
                             t * HK + qc);
        rescale_and_pack<NO, HK>(o, alpha, s, pa);
        wait_phase(r.v_full(st), ph);
        wgmma_fence();
        issue_pv<DC, HK>(o, pa, r.v_tile(st));
        wgmma_wait<0>();
        fence_regs(o);
        warp_arrive(r.v_empty(st), lane);
      }
    } else {
      // Each step issues tile j's Q K^T and tile j-1's P.V as two groups,
      // waits for the first, runs tile j's softmax while the P.V is in
      // flight, waits for the second and rescales. pa (tile j-1's P, read by
      // the P.V in flight) and o are not touched between the issue and the
      // second wait. WIDE rescales o by tile j-1's factors (alpha_prev)
      // after the Q K^T's issue instead, and packs P alone after the wait.
      float2 alpha_prev = make_float2(1.f, 1.f);  // WIDE: o's pending factors
      for (int j = 1; j < n; ++j) {
        const int it = it0 + j, st = it % STAGES, pst = (it - 1) % STAGES;
        wait_phase(r.k_full(st), (it / STAGES) & 1);
        wait_phase(r.v_full(pst), ((it - 1) / STAGES) & 1);
        wgmma_fence();
        QK::issue(acc, sQw, r.k_tile(st));
        if constexpr (WIDE) {
          rescale<NO>(o, alpha_prev);
          wgmma_fence();
        }
        issue_pv<DC, HK>(o, pa, r.v_tile(pst));
        wgmma_wait<1>();
        fence_regs(acc);
        float f[HK / 2];
        auto& s = qk.scores(acc, f, r.k_extra(st), qc);
        warp_arrive(r.k_empty(st), lane);
        const int t = t0 + j;
        const float2 alpha =
            softmax_tile<HK>(s, rs, mask.full(t), qk.row_mul(score_mul), vis_lo, vis_hi,
                             t * HK + qc);
        wgmma_wait<0>();
        fence_regs(o);
        warp_arrive(r.v_empty(pst), lane);
        if constexpr (WIDE) {
          pack<HK>(s, pa);
          alpha_prev = alpha;
        } else {
          rescale_and_pack<NO, HK>(o, alpha, s, pa);
        }
      }
      const int lit = it0 + n - 1, lst = lit % STAGES;
      if constexpr (WIDE) rescale<NO>(o, alpha_prev);
      wait_phase(r.v_full(lst), (lit / STAGES) & 1);
      wgmma_fence();
      issue_pv<DC, HK>(o, pa, r.v_tile(lst));
      wgmma_wait<0>();
      fence_regs(o);
      warp_arrive(r.v_empty(lst), lane);
    }
  }
};

// The key tiles [t0, t1) of a k_len-key sequence (keys from global
// position k_base) that any of the nq rows from global position q0 can see:
// the segment rule makes them one run (a tile inside it that the mask
// empties would only cost time). (0, 0) if none. The last tile is tested
// with its whole HK-key box: keys past k_len are masked per element, so a
// tile reached only through them costs time, not exactness. Clipping the
// box with min() moved the run, and with it the ring positions, barrier
// addresses and wgmma descriptors of the mainloop, off ptxas's uniform
// datapath (per-thread arithmetic and R2UR moves in every iteration: 2-4%
// of K1 at D = 64).
template <int HK>
__device__ __forceinline__ int2 reachable_tiles(const Segments& g, int q0, int nq, int k_base,
                                                int k_len) {
  int t0 = 0, t1 = 0;
  for (int t = (k_len + HK - 1) / HK - 1; t >= 0; --t) {
    if (tile_reachable(g, q0, nq, k_base + t * HK, HK)) {
      t0 = t;
      if (t1 == 0) t1 = t + 1;
    }
  }
  return make_int2(t0, t1);
}

// A [heads, rows, d] bf16 tensor map with a 64 x `box_rows` x 1 box.
bool head_map(CUtensorMap* map, const void* base, int heads, int rows, int d, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  return encode_bf16_map(map, base, 3, dims, strides, box);
}

}  // namespace
