// One step of sequence-parallel ring attention redesigned for Hopper
// (sm_90a): TMA, an mbarrier ring, warp specialisation and wgmma. bf16 in
// and out, the running softmax state in f32.
//
// Replaces, in the JAX package's kernels/ring_rdma.py, K4
// ring_attention_rdma (Pallas body _ring_kernel) at head dims 64 and 128:
// D = 128, the flux double blocks on a `seq` ring (S = 4355 -> 4356 over 4
// ranks: chunks of Lc = 1089); D = 64, the CogVideoX-5b blocks (S = 18002 ->
// 18004: Lc = 4501). Head dim 32 stays on csrc/ring_attention.cu, which also
// holds the hop (ca_ring_copy).
//
// What one launch computes (entry ca_ring_step_sm90_bf16) is what one launch
// of csrc/ring_attention.cu computes, with the same rounding points: ring
// step s for up to MAX_LOCAL_RANKS ranks on one device. Rank `my` holds the
// K/V chunk that originated at rank src = (my - s) mod N; its queries sit at
// global positions my * Lc + i, the chunk's keys at src * Lc + j, and the
// segment mask of flash_common.cuh applies to those positions (the unmasked
// ring is every position in txt). f32 scores times log2(e)/sqrt(D) fused
// into the exp2's argument (no RoPE: the caller ropes each segment before
// fusing), an exp2 online softmax, P rounded to bf16, f32 P.V. At step 0 the
// state starts empty; between steps it lives in f32 buffers, max and sum
// ml [B, H, Lc, 2] (the max in scaled units, -inf for a row that has seen
// nothing) and the accumulator acc [B, H, Lc, D]; at step N-1 the kernel
// writes out = acc / l in bf16, exact 0 where l == 0.
//
// What bounds it on an H100: the same unmasked (q, k) pairs as K1, 4 D
// flops each, some 2000 flops per byte at the flux shape and 4500 at the
// CogVideoX shape: the tensor cores. The state adds 2 x 4 (D + 2) bytes per
// row and step (53.5 MB each way per step at the flux shape). The design is
// K1's (flash_sm90.cuh), one block per (128-query tile of the rank's chunk,
// b * h, local rank):
//   - the producer warpgroup's thread loads the Q tile once and streams the
//     K / V tiles of the chunk this rank holds, skipping the tiles the global
//     mask leaves empty (at the flux shape the txt / img rows of the chunk
//     that holds the concepts see few of its keys); TMA zero-fills the
//     ragged tail of a chunk, and the mask keeps those keys out;
//   - the consumers run the shared Mainloop with K1's schedule at that head
//     dim (in order at 128, overlap at 64); they issue the loads of the
//     running state into the m64 fragment layout before they wait for Q and
//     the first K tile, and store it (or the output) with predicated stores,
//     so a chunk of pad rows or a ragged chunk needs no divergent path;
//   - each local rank has its own three tensor maps; 24 maps of 128 bytes
//     and the state pointers fit the 4 KB of kernel parameters, passed as
//     one __grid_constant__ struct.
// A block that reaches no key tile of the chunk returns at once, unless this
// is the first step (it writes the empty state) or the last (it writes the
// output). The hops are not in this kernel (kernels/ring_rdma.py).

#include "flash_sm90.cuh"

namespace {

constexpr int MAX_LOCAL_RANKS = 8;
constexpr int RING_HK = 128;  // keys per tile

struct RingMaps {  // per local rank: its query chunk, and the K / V chunk it holds
  CUtensorMap q[MAX_LOCAL_RANKS];
  CUtensorMap k[MAX_LOCAL_RANKS];
  CUtensorMap v[MAX_LOCAL_RANKS];
};

struct RingStep {
  float* acc[MAX_LOCAL_RANKS];          // [B*H, Lc, D] running output (steps < N-1)
  float* ml[MAX_LOCAL_RANKS];           // [B*H, Lc, 2] running max and sum
  __nv_bfloat16* out[MAX_LOCAL_RANKS];  // [B*H, Lc, D] written at step N-1
  int rank[MAX_LOCAL_RANKS];
  int lc;         // chunk length
  int ring_size;  // N
  int step;       // s
  Segments g;     // the fused sequence in global positions
  float score_mul;
};

static_assert(sizeof(RingMaps) + sizeof(RingStep) <= 4096, "the kernel's 4 KB of parameters");

// The run [x, y) of chunk-local keys that local row `row` may see: the
// global run of visible_keys moved to the chunk's keys and clipped to it;
// empty for a row past the chunk's end.
__device__ __forceinline__ int2 chunk_visible(const Segments& g, int my, int row, int lc,
                                              int k_base) {
  if (row >= lc) return make_int2(0, 0);
  const int2 vis = visible_keys(g, my * lc + row);
  return make_int2(max(vis.x - k_base, 0), min(vis.y - k_base, lc));
}

// The running state of the thread's rows row_lo and row_lo + 8 of one head
// (acc: [Lc, D], ml: [Lc, 2]) into the m64 fragment layout (see
// flash_sm90.cuh): o[4 c + e] holds column 8 c + qc + (e & 1) of row (e & 2 ?
// hi : lo). The row sum goes to the quad's lead lane (the partials of the
// other lanes are 0). Rows past the chunk read as the empty state.
template <int D>
__device__ __forceinline__ void load_state(float (&o)[D / 2], RowState& rs, const float* acc,
                                           const float* ml, int row_lo, int lc, int qc,
                                           int lane) {
  const bool ok_lo = row_lo < lc, ok_hi = row_lo + 8 < lc, lead = (lane & 3) == 0;
  const float2 s_lo = ld_global_f2_if(ml + (size_t)row_lo * 2, ok_lo);
  const float2 s_hi = ld_global_f2_if(ml + (size_t)(row_lo + 8) * 2, ok_hi);
  rs.m_lo = ok_lo ? s_lo.x : -INFINITY;
  rs.m_hi = ok_hi ? s_hi.x : -INFINITY;
  rs.l_lo = lead ? s_lo.y : 0.f;
  rs.l_hi = lead ? s_hi.y : 0.f;
  const float* lo = acc + (size_t)row_lo * D + qc;
  const float* hi = lo + (size_t)8 * D;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const float2 x = ld_global_f2_if(lo + c * 8, ok_lo);
    const float2 y = ld_global_f2_if(hi + c * 8, ok_hi);
    o[4 * c] = x.x;
    o[4 * c + 1] = x.y;
    o[4 * c + 2] = y.x;
    o[4 * c + 3] = y.y;
  }
}

// The inverse of load_state: (max, whole-row sum) from the quad's lead lane,
// the accumulator from every lane; rows past the chunk are not written.
template <int D>
__device__ __forceinline__ void store_state(const float (&o)[D / 2], const RowState& rs,
                                            float* acc, float* ml, int row_lo, int lc, int qc,
                                            int lane) {
  const bool ok_lo = row_lo < lc, ok_hi = row_lo + 8 < lc, lead = (lane & 3) == 0;
  const float2 l = reduce_sums(rs);
  st_global_f2_if(ml + (size_t)row_lo * 2, rs.m_lo, l.x, ok_lo && lead);
  st_global_f2_if(ml + (size_t)(row_lo + 8) * 2, rs.m_hi, l.y, ok_hi && lead);
  float* lo = acc + (size_t)row_lo * D + qc;
  float* hi = lo + (size_t)8 * D;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    st_global_f2_if(lo + c * 8, o[4 * c], o[4 * c + 1], ok_lo);
    st_global_f2_if(hi + c * 8, o[4 * c + 2], o[4 * c + 3], ok_hi);
  }
}

template <int D, int STAGES, int SCHED>
__global__ void __launch_bounds__(THREADS, 1)
ring_step_sm90_kernel(const __grid_constant__ RingMaps maps, const RingStep a) {
  constexpr int HK = RING_HK;
  using ML = Mainloop<D, D, HK, STAGES, SCHED>;
  constexpr uint32_t Q_BYTES = (D / 64) * HQ * 128;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);  // [D / 64 atoms][HQ rows][128 B]
  const typename ML::Ring ring{sQ + Q_BYTES};
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring.end());

  const int lane = threadIdx.x & 31;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform role
  const int j = blockIdx.z, q0 = blockIdx.x * HQ, bh = blockIdx.y;
  const int lc = a.lc, n_ranks = a.ring_size, my = a.rank[j];
  const int src = ((my - a.step) % n_ranks + n_ranks) % n_ranks;  // origin of the held chunk
  const bool first = a.step == 0, last = a.step == n_ranks - 1;
  const int qg0 = my * lc + q0, k_base = src * lc;  // global positions of the tile and chunk

  const int2 run = reachable_tiles<HK>(a.g, qg0, min(HQ, lc - q0), k_base, lc);
  const int t0 = run.x, t1 = run.y, n = t1 - t0;  // uniform over the block
  if (n == 0 && !first && !last) return;  // nothing of this chunk: the state stays as it is

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    ring.init();
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS / 128) {  // the producer warpgroup
    if (threadIdx.x == CONSUMERS && n > 0) {
      produce_q<D>(sQ, &maps.q[j], q_full, q0, bh);
      ring.produce(&maps.k[j], &maps.v[j], 0, t0, t1, bh, 0);
    }
    return;
  }

  // Consumers: rows row_lo and row_lo + 8 of the chunk (see flash_sm90.cuh
  // for the fragment layout); keys in chunk-local positions.
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int row_lo = q0 + warp * 16 + (lane >> 2);
  const int qc = (lane & 3) * 2;
  const unsigned char* sQw = sQ + wg * 64 * 128;  // this warpgroup's 64 rows in each atom
  const TileMask<HK> mask = TileMask<HK>::make(a.g, qg0, k_base, q0 + HQ <= lc, lc);
  const int2 vis_lo = chunk_visible(a.g, my, row_lo, lc, k_base);
  const int2 vis_hi = chunk_visible(a.g, my, row_lo + 8, lc, k_base);
  float o[ML::NO];
  RowState rs;
  uint32_t pa[HK / 4];
  float sc[HK / 2];

  // The running state, its loads in flight while Q and the first K tile land.
  if (first) {
#pragma unroll
    for (int i = 0; i < ML::NO; ++i) o[i] = 0.f;
  } else {
    load_state<D>(o, rs, a.acc[j] + (size_t)bh * lc * D, a.ml[j] + (size_t)bh * lc * 2, row_lo,
                  lc, qc, lane);
  }
  if (n > 0) {
    ML::begin(sc, ring, sQw, q_full, 0);
    ML::rest(o, rs, sc, pa, ring, sQw, 0, t0, t1, mask, a.score_mul, vis_lo, vis_hi, qc, lane);
  }
  // The buffers' addresses are computed afresh here, not kept live through
  // the mainloop from the loads above.
  const int jj = opaque_int(j);
  const size_t head = (size_t)opaque_int(bh) * lc;
  if (last) {
    store_out_bf16<ML::NO>(o, rs, a.out[jj] + head * D, D, row_lo, lc, qc);
  } else {
    store_state<D>(o, rs, a.acc[jj] + head * D, a.ml[jj] + head * 2, row_lo, lc, qc, lane);
  }
}

template <int D, int STAGES, int SCHED>
cudaError_t launch(const RingMaps& maps, const RingStep& a, int num_local, int batch_heads,
                   cudaStream_t stream) {
  constexpr size_t smem =
      1024 + (size_t)(D / 64) * HQ * 128 + KvRing<D, D, RING_HK, STAGES>::bytes + sizeof(uint64_t);
  static_assert(smem <= 232448, "shared memory of one block on sm_90");
  auto kernel = ring_step_sm90_kernel<D, STAGES, SCHED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.lc + HQ - 1) / HQ, batch_heads, num_local);
  kernel<<<grid, THREADS, smem, stream>>>(maps, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Ring step `step` of `ring_size` for `num_local` ranks on the current
// device, head dims 64 and 128. Per local rank i: q[i], k[i], v[i] (the K/V
// chunk it holds at this step), out[i]: [B, H, Lc, D] bf16, contiguous,
// 16-byte aligned; acc[i] [B, H, Lc, D] and ml[i] [B, H, Lc, 2] f32 (read
// unless step == 0, written unless step == ring_size - 1; may be null when
// ring_size == 1); ranks[i] its place in the ring. Segment lengths are in
// global positions of the fused sequence of ring_size * Lc rows. scale =
// log2(e) / sqrt(D). The same contract as ca_ring_flash_step_bf16 of
// csrc/ring_attention.cu. Returns a cudaError_t.
int ca_ring_step_sm90_bf16(const void* const* q, const void* const* k, const void* const* v,
                           void* const* acc, void* const* ml, void* const* out, const int* ranks,
                           int num_local, int batch, int heads, int chunk_len, int head_dim,
                           int ring_size, int step, int txt_len, int img_len, int concept_len,
                           int cross, int self_attn, float scale, void* stream) {
  if (num_local < 1 || num_local > MAX_LOCAL_RANKS || ring_size < 1 || step < 0 ||
      step >= ring_size || chunk_len < 1 || (head_dim != 64 && head_dim != 128)) {
    return cudaErrorInvalidValue;
  }
  const int bh = batch * heads;
  RingMaps maps;
  RingStep a{};
  for (int i = 0; i < num_local; ++i) {
    if (!head_map(&maps.q[i], q[i], bh, chunk_len, head_dim, HQ) ||
        !head_map(&maps.k[i], k[i], bh, chunk_len, head_dim, RING_HK) ||
        !head_map(&maps.v[i], v[i], bh, chunk_len, head_dim, RING_HK)) {
      return cudaErrorInvalidValue;
    }
    a.acc[i] = static_cast<float*>(acc[i]);
    a.ml[i] = static_cast<float*>(ml[i]);
    a.out[i] = static_cast<__nv_bfloat16*>(out[i]);
    a.rank[i] = ranks[i];
  }
  for (int i = num_local; i < MAX_LOCAL_RANKS; ++i) {  // unused slots: copies of a valid map
    maps.q[i] = maps.q[0];
    maps.k[i] = maps.k[0];
    maps.v[i] = maps.v[0];
  }
  a.lc = chunk_len;
  a.ring_size = ring_size;
  a.step = step;
  a.g = make_segments(ring_size * chunk_len, txt_len, img_len, concept_len, cross, self_attn);
  a.score_mul = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch<64, 4, OVERLAP>(maps, a, num_local, bh, s);
  return launch<128, 2, IN_ORDER>(maps, a, num_local, bh, s);
}

const char* ca_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
