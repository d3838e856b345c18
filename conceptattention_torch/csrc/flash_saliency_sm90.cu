// Fused dual-pass concept flash attention redesigned for Hopper (sm_90a):
// TMA, an mbarrier ring, warp specialisation and wgmma. bf16 in and out.
//
// Replaces, in the JAX package's kernels/flash_saliency.py:
//   K1 fused_concept_flash_attention (Pallas body _flash_kernel) at head
//     dims 64, 128 and 512:
//     D = 128, the flux double blocks (S = 4355 with concepts) and single
//       blocks (S = 4352), and HunyuanVideo's (S ~ 67.5k);
//     D = 64, the CogVideoX-5b blocks (B = 2, 48 heads, S = 18002);
//     D = 512, the flux VAE decoder's mid-attention (one head, S = 16384, no
//       RoPE, no concepts);
//   K3 fused_concept_flash_attention_paired (Pallas body
//     _flash_kernel_paired): the same function for head dim 64, an even head
//     count and RoPE (entry ca_flash_saliency_paired_sm90_bf16).
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
//     output per block and runs the mainloop of flash_sm90.cuh: a producer
//     warpgroup's thread issues every TMA copy into a STAGES-deep mbarrier
//     ring, skipping the key tiles the segment mask leaves empty; two
//     consumer warpgroups of 64 query rows run wgmma Q K^T (both operands in
//     shared memory), the online softmax on the accumulator registers and
//     wgmma P V with P from registers.
//
// The instances (<D, DC, HK, STAGES, schedule, heads per block>):
//   D = 128: <128, 128, 192, 2, overlap wide, 1>, the flux and HunyuanVideo
//     DiT blocks' kernel (instance 3 of the run-time choice below). The
//     exponentials cost half the products (S^2 exp2 at 16 a clock per SM
//     against 4 S^2 D flops), so the softmax has to run beside the products
//     as at D = 64, but OVERLAP holds o[64], s[HK/2] and P[HK/4] and spilled
//     under the 168 registers of a three-warpgroup block. The producer
//     warpgroup gives its registers to the consumers (setmaxnreg: 24 for the
//     producer, 240 for each consumer, 64,512 of the SM's 65,536), and with
//     them the overlap fits 192-key tiles (s[96], P[48]: the wgmma's N; the
//     ring of two 96 KB stages and the 32 KB Q tile fill 225 KB of shared
//     memory) without a spill. The consumers' waits spin without the
//     watchdog (a trap on their path sends ptxas back to 168 registers); the
//     producer's keep it. D = 64 keeps its 168 registers (its overlap fits
//     them), and so do D = 512, K3, K1b and K4's step: their instances
//     compile as before (the schedule value gates every change);
//   D = 64: the exponentials cost as much as the products (B H S^2 = 3.1e10
//     exp2 at 16 a clock per SM is ~8 ms, as the tensor cores' 7.95 ms), so
//     the softmax has to run beside the products: schedule "overlap" issues
//     tile j+1's Q K^T and tile j's P.V together and runs tile j+1's softmax
//     while P.V is in flight (one warpgroup holds o[32], s[64] and P[32]).
//     <64, 64, 128, 4, overlap, 1>;
//   D = 512: a 64 x 512 f32 output would take 256 registers a thread, and a
//     consumer gets 168, so the output's columns are split in four 128-column
//     chunks (blockIdx.z), each recomputing Q K^T over all 512 channels
//     (1375 of 550 GFLOP at the VAE shape; two 256-column chunks need 128
//     output registers and more than the 168, and ptxas spills them and
//     serialises their wgmma). Q (128 rows x 512) takes 128 KB of shared
//     memory, so the key tiles are 64 keys and the ring one stage deep:
//     <512, 128, 64, 1, in order, 1>;
//   K3, D = 64 with the heads paired: <64, 64, 128, 4, overlap, 2>. The
//     TPU kernel pairs heads to fill its 128-lane vregs with two 64-wide
//     heads; Hopper has no such need, and after the pre-pass the two heads
//     of a pair share no arithmetic. What a pair can share is a block's fill
//     and drain: one block takes a 128-query tile of both heads and walks
//     them in turn through one ring. The producer runs on from head a's last
//     key tile into head b's first without draining the ring (the ring
//     position carries over, so its phase bits do too when a head's tile
//     count is not a multiple of the stages), head b's Q tile lands in a
//     second buffer (2 x 16 KB of Q and 4 x 32 KB of K and V) while head a
//     computes, so head b's first tiles are in shared memory when head a's
//     output has been stored. (Storing head a's output while head b's first
//     Q K^T is in flight made ptxas serialise every wgmma of the kernel.)
//     The tile run and the mask decisions are computed once a block.
//   D = 128, the candidates of the run-time instance choice
//     (ca_flash_saliency_sm90_bf16_instance; kernels/autotune.py measures
//     them on the card, the port's counterpart of the JAX autotuner's tile
//     sweep, since the tile shape here is fixed at compile time):
//     0 <128, 128, 128, 2, in order, 1>, one tile's steps at a time;
//     1 <128, 128, 128, 2, pingpong, 1>, K1b's schedule: one consumer
//       warpgroup's softmax runs while the other's products do;
//     2 <128, 128, 64, 4, in order, 1>, 64-key tiles and a 4-deep ring, for
//       rows that walk few key tiles (S ~ 1286: 11 tiles of 128 keys);
//     3 <128, 128, 192, 2, overlap wide, 1>, the default above: faster than
//       0-2 at every shape measured, from S = 1286 (7 tiles a row) to
//       67.5k (351).
//     (Not compiled, each slower than instance 3 where it was timed: the
//     output split in two 64-column chunks, <128, 64, 128, 2, in order, 1>,
//     which computes Q K^T twice; the wide overlap on 128- and 176-key tiles,
//     with a third ring stage, and with pingpong's turns on top.)
// Not yet done: a TMA store of the output, a persistent grid, multicast of
// K and V across a cluster (the D = 512 instance streams 20 MB a block from
// L2).

#include "flash_sm90.cuh"

namespace {

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

// q, k (roped and q pre-scaled, or raw with score_mul = scale), v: [B*H, S,
// D] bf16 through 3D tensor maps (box 64 x HQ or HK rows x 1 head); out:
// [B*H, S, D] bf16. Block (query tile, NH heads from blockIdx.y * NH,
// DC-column chunk). Warpgroups 0 and 1 consume; warpgroup 2 produces, one
// thread issuing every copy. A block whose rows see no key loads nothing and
// writes zeros.
template <int D, int DC, int HK, int STAGES, int SCHED, int NH>
__global__ void __launch_bounds__(THREADS, 1)
flash_saliency_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           __nv_bfloat16* __restrict__ out, Segments g, float score_mul) {
  using ML = Mainloop<D, DC, HK, STAGES, SCHED>;
  constexpr uint32_t Q_BYTES = (D / 64) * HQ * 128;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);  // [NH][D / 64 atoms][HQ rows][128 B]
  const typename ML::Ring ring{sQ + NH * Q_BYTES};
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring.end());

  const int lane = threadIdx.x & 31;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform role
  const int q0 = blockIdx.x * HQ, bh0 = blockIdx.y * NH, c0 = blockIdx.z * DC;
  const int S = g.seq_len;

  if (threadIdx.x == 0) {
    for (int h = 0; h < NH; ++h) mbar_init(q_full + h, 1);
    ring.init();
    fence_barrier_init();
  }
  __syncthreads();

  // One run for every head of the block: the heads share positions.
  const int2 run = reachable_tiles<HK>(g, q0, HQ, 0, S);
  const int t0 = run.x, t1 = run.y, n = t1 - t0;  // uniform over the block

  if (wg == CONSUMERS / 128) {  // the producer warpgroup
    if constexpr (ML::WIDE) setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS && n > 0) {
      for (int h = 0; h < NH; ++h) {
        produce_q<D>(sQ + h * Q_BYTES, &map_q, q_full + h, q0, bh0 + h);
        ring.produce(&map_k, &map_v, h * n, t0, t1, bh0 + h, c0);
      }
    }
    return;
  }
  if constexpr (ML::WIDE) setmaxnreg_inc<CONSUMER_REGS>();

  // Consumers. Thread (warpgroup wg, lane) of warp w holds rows row_lo and
  // row_lo + 8; its score element i sits at row (i & 2 ? hi : lo), key
  // k0 + 8 * (i / 4) + qc + (i & 1), as its output element i at column
  // c0 + 8 * (i / 4) + qc + (i & 1).
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0);
  const int row_lo = q0 + warp * 16 + (lane >> 2);
  const int qc = (lane & 3) * 2;
  const unsigned char* sQw = sQ + wg * 64 * 128;  // this warpgroup's 64 rows in each atom
  const TileMask<HK> mask = TileMask<HK>::make(g, q0, 0, q0 + HQ <= S, S);
  const int2 vis_lo = visible_keys(g, row_lo), vis_hi = visible_keys(g, row_lo + 8);
  float o[ML::NO];
#pragma unroll
  for (int i = 0; i < ML::NO; ++i) o[i] = 0.f;
  RowState rs;
  uint32_t pa[HK / 4];  // P in bf16: the A fragments of the tile's P.V
  float sc[HK / 2];     // the scores of the tile in hand

  auto head = [&](int h) {  // head bh0 + h, its tiles at ring positions from h * n
    if (n > 0) {
      ML::begin(sc, ring, sQw + h * Q_BYTES, q_full + h, h * n);
      ML::rest(o, rs, sc, pa, ring, sQw + h * Q_BYTES, h * n, t0, t1, mask, score_mul, vis_lo,
               vis_hi, qc, lane);
    }
    store_out_bf16<ML::NO>(o, rs, out + (size_t)(bh0 + h) * S * D + c0, D, row_lo, S, qc);
  };
  if constexpr (NH == 1) {
    head(0);
  } else {
#pragma unroll 1
    for (int h = 0; h < NH; ++h) {
      if (h > 0) {
#pragma unroll
        for (int i = 0; i < ML::NO; ++i) o[i] = 0.f;
        rs = RowState();
      }
      head(h);
    }
  }
}

template <int D, int DC, int HK, int STAGES, int SCHED, int NH>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bh, Segments g,
                   float score_mul, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!head_map(&mq, q, bh, g.seq_len, D, HQ) || !head_map(&mk, k, bh, g.seq_len, D, HK) ||
      !head_map(&mv, v, bh, g.seq_len, D, HK)) {
    return cudaErrorInvalidValue;
  }
  constexpr size_t smem = 1024 + (size_t)NH * (D / 64) * HQ * 128 +
                          KvRing<D, DC, HK, STAGES>::bytes + sizeof(uint64_t) * NH;
  static_assert(smem <= 232448, "shared memory of one block on sm_90");
  auto kernel = flash_saliency_sm90_kernel<D, DC, HK, STAGES, SCHED, NH>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((g.seq_len + HQ - 1) / HQ, bh / NH, D / DC);
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

int ca_flash_saliency_sm90_bf16_instance(const void* q, const void* k, const void* v, void* out,
                                         int batch, int heads, int seq_len, int head_dim,
                                         int txt_len, int img_len, int concept_len, int cross,
                                         int self_attn, float score_mul, int instance,
                                         void* stream);

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
// Head dims 64, 128 and 512, each through its instance 0. Returns a
// cudaError_t.
int ca_flash_saliency_sm90_bf16(const void* q, const void* k, const void* v, void* out,
                                int batch, int heads, int seq_len, int head_dim, int txt_len,
                                int img_len, int concept_len, int cross, int self_attn,
                                float score_mul, void* stream) {
  return ca_flash_saliency_sm90_bf16_instance(q, k, v, out, batch, heads, seq_len, head_dim,
                                              txt_len, img_len, concept_len, cross, self_attn,
                                              score_mul, 0, stream);
}

// The same contract through one compiled instance: `instance` indexes the
// head dim's instances (0 at D = 64 and 512; 0-2 at D = 128, in the order of
// FLASH_D128_INSTANCES). An index outside them returns cudaErrorInvalidValue.
int ca_flash_saliency_sm90_bf16_instance(const void* q, const void* k, const void* v, void* out,
                                         int batch, int heads, int seq_len, int head_dim,
                                         int txt_len, int img_len, int concept_len, int cross,
                                         int self_attn, float score_mul, int instance,
                                         void* stream) {
  const Segments g = make_segments(seq_len, txt_len, img_len, concept_len, cross, self_attn);
  const int bh = batch * heads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64 && instance == 0) {
    return launch<64, 64, 128, 4, OVERLAP, 1>(q, k, v, out, bh, g, score_mul, s);
  }
  if (head_dim == 128) {
    switch (instance) {
      case 0: return launch<128, 128, 128, 2, IN_ORDER, 1>(q, k, v, out, bh, g, score_mul, s);
      case 1: return launch<128, 128, 128, 2, PINGPONG, 1>(q, k, v, out, bh, g, score_mul, s);
      case 2: return launch<128, 128, 64, 4, IN_ORDER, 1>(q, k, v, out, bh, g, score_mul, s);
      case 3: return launch<128, 128, 192, 2, OVERLAP_WIDE, 1>(q, k, v, out, bh, g, score_mul, s);
      default: return cudaErrorInvalidValue;
    }
  }
  if (head_dim == 512 && instance == 0) {
    return launch<512, 128, 64, 1, IN_ORDER, 1>(q, k, v, out, bh, g, score_mul, s);
  }
  return cudaErrorInvalidValue;
}

// K3: the same contract for head dim 64 and an even head count, q and k
// roped by ca_rope_qk_rows_bf16 (score_mul = 1); a block takes one query
// tile of the two heads of a pair. Returns a cudaError_t.
int ca_flash_saliency_paired_sm90_bf16(const void* q, const void* k, const void* v, void* out,
                                       int batch, int heads, int seq_len, int head_dim,
                                       int txt_len, int img_len, int concept_len, int cross,
                                       int self_attn, float score_mul, void* stream) {
  if (head_dim != 64 || heads % 2 != 0) return cudaErrorInvalidValue;
  const Segments g = make_segments(seq_len, txt_len, img_len, concept_len, cross, self_attn);
  return launch<64, 64, 128, 4, OVERLAP, 2>(q, k, v, out, batch * heads, g, score_mul,
                                            static_cast<cudaStream_t>(stream));
}

const char* ca_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
