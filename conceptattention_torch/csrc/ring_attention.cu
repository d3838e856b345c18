// One step of sequence-parallel ring attention for Hopper (sm_90a), bf16 in and out.
//
// Replaces, in the JAX package's kernels/ring_rdma.py:
//   K4 ring_attention_rdma (Pallas body _ring_kernel), the "ring_rdma"
//   attention backend: the fused sequence S = [txt | img | concept | pad] is
//   split into N chunks of Lc rows, one per rank of the `seq` ring; each rank
//   keeps its query chunk while the K/V chunks travel around the ring, and
//   folds each chunk into an online softmax.
//
// What one launch computes (entry ca_ring_flash_step_bf16): ring step s for
// one or more ranks that live on one device. Rank `my` holds the K/V chunk
// that originated at rank src = (my - s) mod N. Queries sit at global
// positions my*Lc + i and keys at src*Lc + j, and the segment mask of
// flash_common.cuh applies to those global positions:
//   q in txt|img   sees  k in txt|img
//   q in concept   sees  k in img (if cross), k in concept (if self_attn)
//   q in pad       sees  nothing -> exact zeros
// (the unmasked ring is the same mask with every position in txt). Scores are
// f32 sums of bf16 products times log2(e)/sqrt(D) (no RoPE: the caller ropes
// each segment before fusing, as the JAX backend does); the softmax runs in
// the exp2 domain; P is rounded to bf16 for P.V; every product accumulates in
// f32. At step 0 the running state starts empty; between steps it lives in
// f32 buffers (max and sum [B, H, Lc, 2], output accumulator [B, H, Lc, D]);
// at step N-1 the kernel writes out = acc / l in bf16, 0 where l == 0.
//
// The hops are not in this kernel. The TPU kernel pushes each chunk to its
// right neighbour by remote DMA from inside the kernel, with semaphores for
// flow control. Here a hop is a device copy (cudaMemcpyPeerAsync, entry
// ca_ring_copy; over NVLink between two cards) on a copy stream, ordered
// against the step launches by CUDA events in kernels/ring_rdma.py: the copy
// of step s into a rank's slot waits for the step that last read that slot,
// and step s+1 waits for the copy. An in-kernel spin-wait on a neighbour's
// flag would need every rank's blocks resident at once, which nothing
// guarantees for N ranks on one card with thousands of blocks each; an
// in-kernel peer-store hop with flags and a cooperative launch is queued as
// K4's speed step (ROADMAP).
//
// What bounds it on an H100: the same unmasked (q, k) pairs as K1 (4 D flops
// each: Q.K^T and P.V), some 2000 flops per byte at the flux shape and 4500 at
// the CogVideoX shape, far above the card's ~295 ridge: tensor-core
// throughput, not HBM. The f32 state adds 2 x 4 (D + 2) bytes per row and
// step, small against the chunk's flops. The design follows K1: a block of 4
// warps takes 64 query rows of one (b, h) of one rank (the rank is
// blockIdx.z, so one launch fills the card for all ranks that share it); it
// sweeps the chunk's 64-key tiles, skipping the tiles the global mask leaves
// empty (at the flux shape the txt/img rows of the chunk that holds the
// concepts see few of its keys) and masking per element only in tiles the
// mask or the ragged chunk tail cuts; mma.sync m16n8k16 bf16 with the scores,
// P and the running output in registers; K and V arrive by cp.async. A block
// whose rows see nothing of the chunk leaves its state as it is.

#include "flash_common.cuh"

namespace {

constexpr int RBQ = 64, RNT = 128;  // 4 warps x 16 query rows
constexpr int MAX_LOCAL_RANKS = 8;

struct RankPtrs {
  const __nv_bfloat16* q[MAX_LOCAL_RANKS];  // [B, H, Lc, D] query chunk
  const __nv_bfloat16* k[MAX_LOCAL_RANKS];  // [B, H, Lc, D] the K/V chunk held at this step
  const __nv_bfloat16* v[MAX_LOCAL_RANKS];
  float* acc[MAX_LOCAL_RANKS];              // [B, H, Lc, D] running output (steps < N-1)
  float* ml[MAX_LOCAL_RANKS];               // [B, H, Lc, 2] running max and sum
  __nv_bfloat16* out[MAX_LOCAL_RANKS];      // [B, H, Lc, D] written at step N-1
  int rank[MAX_LOCAL_RANKS];
};

struct StepArgs {
  int lc;         // chunk length
  int ring_size;  // N
  int step;       // s
  Segments g;     // the fused sequence in global positions
  float scale;    // log2(e) / sqrt(D)
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(__nv_bfloat16) * (size_t)(RBQ + 2 * BK) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(RNT)
ring_flash_step_kernel(const RankPtrs p, const StepArgs a) {
  static_assert(D % 16 == 0 && D <= 128, "head dims 32, 64, 128");
  constexpr int LD = D + 8;   // bf16 row stride in shared memory (16-byte pad)
  constexpr int NS = BK / 8;  // 8-key score tiles per warp row block
  constexpr int NO = D / 8;   // 8-column output tiles per warp row block
  static_assert(NS * 4 == 32, "one mask bit per score element of a lane");

  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [RBQ][LD]
  __nv_bfloat16* sK = sQ + RBQ * LD;                                // [BK][LD]
  __nv_bfloat16* sV = sK + BK * LD;                                 // [BK][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad_row = lane >> 2, quad_col = (lane & 3) * 2;
  const int j = blockIdx.z, q0 = blockIdx.x * RBQ;
  const int lc = a.lc, n = a.ring_size;
  const int my = p.rank[j];
  const int src = ((my - a.step) % n + n) % n;  // origin rank of the chunk this rank holds
  const bool first = a.step == 0, last = a.step == n - 1;
  const size_t head = (size_t)blockIdx.y * lc * D;  // this (b, h) in a [B, H, Lc, D] shard
  const size_t row0 = (size_t)blockIdx.y * lc;      // its first row in the [B, H, Lc] state
  const int qg0 = my * lc + q0;                     // global position of the tile's first query
  const int kg_base = src * lc;                     // global position of the chunk's first key

  if (!first && !last && !tile_reachable(a.g, qg0, min(RBQ, lc - q0), kg_base, lc)) return;

  for (int e = tid; e < RBQ * D / 8; e += RNT) {
    const int r = e / (D / 8), c = (e % (D / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < lc) val = *reinterpret_cast<const uint4*>(p.q[j] + head + (size_t)(q0 + r) * D + c);
    *reinterpret_cast<uint4*>(sQ + r * LD + c) = val;
  }

  const int w0 = warp * 16;  // this warp's first query row in the tile
  const int lq_lo = q0 + w0 + quad_row, lq_hi = lq_lo + 8;  // local rows of this lane
  const int gq_lo = my * lc + lq_lo, gq_hi = gq_lo + 8;
  const bool ok_lo = lq_lo < lc, ok_hi = lq_hi < lc;
  float* const ml = p.ml[j];
  float* const acc = p.acc[j];

  // The running state: max and sum per row (the sum as per-lane partials,
  // the whole row sum on the quad's first lane) and the output accumulator.
  float o[NO][4];
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  if (first) {
#pragma unroll
    for (int t = 0; t < NO; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  } else {
    const bool lead = (lane & 3) == 0;
    if (ok_lo) {
      m_lo = ml[(row0 + lq_lo) * 2];
      l_lo = lead ? ml[(row0 + lq_lo) * 2 + 1] : 0.f;
    }
    if (ok_hi) {
      m_hi = ml[(row0 + lq_hi) * 2];
      l_hi = lead ? ml[(row0 + lq_hi) * 2 + 1] : 0.f;
    }
#pragma unroll
    for (int t = 0; t < NO; ++t) {
      const int c = t * 8 + quad_col;
      const float2 lo = ok_lo ? *reinterpret_cast<const float2*>(acc + head + (size_t)lq_lo * D + c)
                              : make_float2(0.f, 0.f);
      const float2 hi = ok_hi ? *reinterpret_cast<const float2*>(acc + head + (size_t)lq_hi * D + c)
                              : make_float2(0.f, 0.f);
      o[t][0] = lo.x;
      o[t][1] = lo.y;
      o[t][2] = hi.x;
      o[t][3] = hi.y;
    }
  }
  bool changed = first;  // does this warp's state need writing back

  for (int k0 = 0; k0 < lc; k0 += BK) {
    const int kg0 = kg_base + k0, nk = min(BK, lc - k0);
    if (!tile_reachable(a.g, qg0, min(RBQ, lc - q0), kg0, nk)) continue;
    __syncthreads();  // the previous tile's reads of sK / sV are done

    for (int e = tid; e < BK * D / 8; e += RNT) {
      const int r = e / (D / 8), c = (e % (D / 8)) * 8;
      __nv_bfloat16* dk = sK + r * LD + c;
      __nv_bfloat16* dv = sV + r * LD + c;
      if (r < nk) {
        const size_t off = head + (size_t)(k0 + r) * D + c;
        cp_async16(dk, p.k[j] + off);
        cp_async16(dv, p.v[j] + off);
      } else {  // past the chunk's end: zeros, so no garbage reaches P.V
        *reinterpret_cast<uint4*>(dk) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(dv) = make_uint4(0, 0, 0, 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    if (q0 + w0 >= lc || !tile_reachable(a.g, qg0 + w0, 16, kg0, nk)) continue;  // warp-uniform
    changed = true;

    // Mask bits of this lane's score elements (bit 4t + e); all set when the
    // tile needs no per-element mask.
    const bool full = tile_full(a.g, qg0 + w0, 16, kg0, BK) && k0 + BK <= lc && q0 + w0 + 16 <= lc;
    uint32_t ok_bits = 0xffffffffu;
    if (!full) {
      ok_bits = 0;
#pragma unroll
      for (int t = 0; t < NS; ++t) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = k0 + t * 8 + quad_col + (e & 1);
          const bool ok = kl < lc && allowed(a.g, e < 2 ? gq_lo : gq_hi, kg_base + kl);
          ok_bits |= (uint32_t)ok << (4 * t + e);
        }
      }
    }

    // Scores of this warp's 16 rows against the BK keys.
    float s[NS][4];
#pragma unroll
    for (int t = 0; t < NS; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      ldmatrix_x4(af, sQ + (w0 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int t = 0; t < NS / 2; ++t) {
        uint32_t kb[4];
        ldmatrix_x4(kb, sK + (t * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * t], af, kb[0], kb[1]);
        mma_bf16(s[2 * t + 1], af, kb[2], kb[3]);
      }
    }

    // Online softmax update of rows lo (elements 0, 1) and hi (2, 3); the
    // four lanes of a quad share a row.
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int t = 0; t < NS; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[t][e] = (ok_bits >> (4 * t + e)) & 1u ? s[t][e] * a.scale : -INFINITY;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[t][0], s[t][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[t][2], s[t][3]));
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
    for (int t = 0; t < NS; ++t) {
      s[t][0] = exp2f(s[t][0] - ref_lo);
      s[t][1] = exp2f(s[t][1] - ref_lo);
      s[t][2] = exp2f(s[t][2] - ref_hi);
      s[t][3] = exp2f(s[t][3] - ref_hi);
      sum_lo += s[t][0] + s[t][1];
      sum_hi += s[t][2] + s[t][3];
    }
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
    for (int t = 0; t < NO; ++t) {
      o[t][0] *= alpha_lo;
      o[t][1] *= alpha_lo;
      o[t][2] *= alpha_hi;
      o[t][3] *= alpha_hi;
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
      for (int c = 0; c < NO / 2; ++c) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, sV + (t * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c * 16 +
                                  (lane >> 4) * 8);
        mma_bf16(o[2 * c], pa, vb[0], vb[1]);
        mma_bf16(o[2 * c + 1], pa, vb[2], vb[3]);
      }
    }
  }

  float sl = l_lo, sh = l_hi;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    sl += __shfl_xor_sync(0xffffffffu, sl, off);
    sh += __shfl_xor_sync(0xffffffffu, sh, off);
  }
  if (last) {
    const float inv_lo = sl == 0.f ? 0.f : 1.f / sl;  // rows that saw nothing: exact zeros
    const float inv_hi = sh == 0.f ? 0.f : 1.f / sh;
    __nv_bfloat16* out = p.out[j] + head;
#pragma unroll
    for (int t = 0; t < NO; ++t) {
      const int c = t * 8 + quad_col;
      if (ok_lo) {
        *reinterpret_cast<uint32_t*>(out + (size_t)lq_lo * D + c) =
            pack_bf16(o[t][0] * inv_lo, o[t][1] * inv_lo);
      }
      if (ok_hi) {
        *reinterpret_cast<uint32_t*>(out + (size_t)lq_hi * D + c) =
            pack_bf16(o[t][2] * inv_hi, o[t][3] * inv_hi);
      }
    }
  } else if (changed) {
    if ((lane & 3) == 0) {
      if (ok_lo) *reinterpret_cast<float2*>(ml + (row0 + lq_lo) * 2) = make_float2(m_lo, sl);
      if (ok_hi) *reinterpret_cast<float2*>(ml + (row0 + lq_hi) * 2) = make_float2(m_hi, sh);
    }
#pragma unroll
    for (int t = 0; t < NO; ++t) {
      const int c = t * 8 + quad_col;
      if (ok_lo) {
        *reinterpret_cast<float2*>(acc + head + (size_t)lq_lo * D + c) = make_float2(o[t][0], o[t][1]);
      }
      if (ok_hi) {
        *reinterpret_cast<float2*>(acc + head + (size_t)lq_hi * D + c) = make_float2(o[t][2], o[t][3]);
      }
    }
  }
}

template <int D>
cudaError_t launch(const RankPtrs& p, const StepArgs& a, int num_local, int batch_heads,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  auto kernel = ring_flash_step_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.lc + RBQ - 1) / RBQ, batch_heads, num_local);
  kernel<<<grid, RNT, smem, stream>>>(p, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Ring step `step` of `ring_size` for `num_local` ranks on the current
// device. Per local rank i: q[i], k[i], v[i] (the K/V chunk it holds at this
// step), out[i]: [B, H, Lc, D] bf16, contiguous; acc[i] [B, H, Lc, D] and
// ml[i] [B, H, Lc, 2] f32 (read unless step == 0, written unless step ==
// ring_size - 1; may be null when ring_size == 1); ranks[i] its place in the
// ring. Segment lengths are in global positions of the fused sequence of
// ring_size * Lc rows. scale = log2(e) / sqrt(D). Returns a cudaError_t.
int ca_ring_flash_step_bf16(const void* const* q, const void* const* k, const void* const* v,
                            void* const* acc, void* const* ml, void* const* out, const int* ranks,
                            int num_local, int batch, int heads, int chunk_len, int head_dim,
                            int ring_size, int step, int txt_len, int img_len, int concept_len,
                            int cross, int self_attn, float scale, void* stream) {
  if (num_local < 1 || num_local > MAX_LOCAL_RANKS || ring_size < 1 || step < 0 ||
      step >= ring_size || chunk_len < 1) {
    return cudaErrorInvalidValue;
  }
  RankPtrs p{};
  for (int i = 0; i < num_local; ++i) {
    p.q[i] = static_cast<const __nv_bfloat16*>(q[i]);
    p.k[i] = static_cast<const __nv_bfloat16*>(k[i]);
    p.v[i] = static_cast<const __nv_bfloat16*>(v[i]);
    p.acc[i] = static_cast<float*>(acc[i]);
    p.ml[i] = static_cast<float*>(ml[i]);
    p.out[i] = static_cast<__nv_bfloat16*>(out[i]);
    p.rank[i] = ranks[i];
  }
  const StepArgs a{chunk_len, ring_size, step,
                   make_segments(ring_size * chunk_len, txt_len, img_len, concept_len, cross,
                                 self_attn),
                   scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32:
      return launch<32>(p, a, num_local, batch * heads, s);
    case 64:
      return launch<64>(p, a, num_local, batch * heads, s);
    case 128:
      return launch<128>(p, a, num_local, batch * heads, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// One ring hop: `bytes` from src on src_device to dst on dst_device, ordered
// on `stream` (a peer copy between two cards, a device copy on one).
int ca_ring_copy(void* dst, int dst_device, const void* src, int src_device, size_t bytes,
                 void* stream) {
  return cudaMemcpyPeerAsync(dst, dst_device, src, src_device, bytes,
                             static_cast<cudaStream_t>(stream));
}

const char* ca_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
