// 3x3 stride-1 SAME convolution over NHWC, bf16, redesigned for Hopper
// (sm_90a): an implicit GEMM fed by TMA through an mbarrier ring, with
// wgmma products, warp specialisation and a TMA-stored epilogue.
//
// Replaces: the JAX package's kernels/conv3x3.py, conv3x3_same (Pallas
//   body _conv_kernel), the VAE decoder's 3x3 convs, for bf16 with
//   Cin % 64 == 0 and Cout % 8 == 0 (every conv the gate admits). The f32
//   variant and other channel counts stay on csrc/conv3x3.cu.
//
// What it computes: y[b, r, c, n] = sum_{dy, dx, ci} x[b, r+dy-1, c+dx-1, ci]
//   * w[dy, dx, ci, n] + bias[n], zeros outside the border, f32
//   accumulation, bias and optional swish on the f32 accumulator, bf16 out.
//   As a GEMM: M = B*H*W output pixels, N = Cout, K = 9*Cin, the HWIO weight
//   read as a row-major [9*Cin, Cout] matrix.
//
// What bounds it on an H100: 2*9*Cin flops per output element against
// ~2*(Cin + Cout) bytes per pixel, several hundred flops per byte at the
// decoder's shapes: the tensor cores. The design:
//   - a block computes a 128-pixel x BN output tile (BN = 256 where Cout >=
//     256, else 128). The 128 pixels are a BW x BH rectangle of one image
//     (one 128-wide row segment when W >= 128, as on every decoder shape);
//   - a K step is 64 channels of one tap. Its A tile is one TMA load of the
//     box {64 ch, BW, BH, 1} at (ci0, x0+dx-1, y0+dy-1, b): TMA fills the
//     coordinates outside the image with zeros, which is the SAME border,
//     with no halo code. Its B tile is BN/64 TMA loads of 64 x 64 weights;
//   - warp 8 is the producer and keeps STAGES K steps in flight in an
//     mbarrier ring; warps 0-7 are two consumer warpgroups of 64 pixels,
//     each issuing wgmma m64nBNk16 from shared memory (B read N-major, as
//     stored, through the transpose bit) and keeping one group in flight;
//   - the epilogue adds the bias and applies swish in f32 registers, packs
//     to bf16 into a swizzled shared tile and writes it with TMA stores,
//     which clip the ragged edges (W, H or Cout not a multiple of the tile).
// Not yet done: a persistent grid that overlaps one tile's epilogue with the
// next tile's loads, clusters that share the weight tiles.

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int TM = 128, TK = 64;               // output pixels per block, channels per K step
constexpr int CONSUMERS = 256, THREADS = 288;  // two consumer warpgroups + one producer warp
constexpr int STAGES = 4;

struct ConvGeom {
  int cin, cout;
  int bw, bh;                   // pixel rectangle of a block, bw * bh = TM
  int tiles_w, tiles_h, tiles_n;
};

template <int BN>
struct ConvLayout {
  static constexpr uint32_t A_BYTES = TM * TK * 2, B_BYTES = TK * BN * 2;
  static constexpr uint32_t STAGE = A_BYTES + B_BYTES;
  static constexpr size_t bytes = 1024 + (size_t)STAGES * STAGE + sizeof(uint64_t) * 2 * STAGES;
  static_assert(2 * (BN / 64) * 8192 <= STAGES * STAGE, "the epilogue tile fits in the ring");
};

__device__ __forceinline__ float epilogue(float acc, float bias, bool swish) {
  const float y = acc + bias;
  return swish ? y * (1.f / (1.f + expf(-y))) : y;
}

__device__ __forceinline__ uint32_t pack_bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_sm90_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w,
                    const __grid_constant__ CUtensorMap map_out,
                    const __nv_bfloat16* __restrict__ bias, ConvGeom s, int swish) {
  using L = ConvLayout<BN>;
  constexpr int NACC = BN / 2;  // f32 accumulator registers per thread

  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align_1024(smem_raw);  // [STAGES][A tile | B tile]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * L::STAGE);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int t = blockIdx.x;
  const int nt = t % s.tiles_n;
  t /= s.tiles_n;
  const int tx = t % s.tiles_w;
  t /= s.tiles_w;
  const int ty = t % s.tiles_h, b = t / s.tiles_h;
  const int x0 = tx * s.bw, y0 = ty * s.bh, n0 = nt * BN;
  const int chunks = s.cin / TK, ksteps = 9 * chunks;

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, CONSUMERS / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // the producer warp; one lane issues every copy
    if (lane == 0) {
      for (int kt = 0; kt < ksteps; ++kt) {
        const int st = kt % STAGES;
        mbar_wait(empty + st, ((kt / STAGES) & 1) ^ 1);
        unsigned char* sA = ring + st * L::STAGE;
        unsigned char* sB = sA + L::A_BYTES;
        const int tap = kt / chunks, ci0 = (kt % chunks) * TK;
        mbar_expect_tx(full + st, L::STAGE);
        tma_load_4d(sA, &map_x, full + st, ci0, x0 + tap % 3 - 1, y0 + tap / 3 - 1, b);
        // weight rows tap * Cin + ci0 = kt * 64
        for (int h = 0; h < BN / 64; ++h) tma_load_2d(sB + h * 8192, &map_w, full + st, n0 + h * 64, kt * TK);
      }
    }
    return;
  }

  const int wg = warp >> 2, wl = warp & 3;
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < ksteps; ++kt) {
    const int st = kt % STAGES;
    mbar_wait(full + st, (kt / STAGES) & 1);
    const unsigned char* sA = ring + st * L::STAGE + wg * 64 * 128;  // this warpgroup's 64 pixels
    const unsigned char* sB = ring + st * L::STAGE + L::A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < TK / 16; ++k) {
      const uint64_t da = desc_sw128(sA + k * 32, 16, 1024);
      const uint64_t db = desc_sw128(sB + k * 2048, 8192, 1024);
      if constexpr (BN == 256) {
        wgmma_m64n256k16_ss<1>(acc, da, db, 1);
      } else {
        wgmma_m64n128k16_ss<1>(acc, da, db, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done: release its stage
    if (kt > 0) warp_arrive(empty + (kt - 1) % STAGES, lane);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // Both warpgroups are done with the ring; reuse it for the output tile:
  // per warpgroup BN/64 boxes of 64 pixels x 64 channels, 128-byte swizzled.
  named_barrier_sync(1, CONSUMERS);
  unsigned char* sOut = ring + wg * (BN / 64) * 8192;
  const int qc = (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = j * 8 + qc, n = n0 + col;
    float b0 = 0.f, b1 = 0.f;
    if (n < s.cout) {  // Cout % 8 == 0: the pair is inside or outside together
      const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bias + n);
      b0 = __bfloat162float(bb.x);
      b1 = __bfloat162float(bb.y);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = wl * 16 + (lane >> 2) + 8 * half;  // pixel within the warpgroup's 64
      const uint32_t v = pack_bf16_pair(epilogue(acc[4 * j + 2 * half], b0, swish),
                                        epilogue(acc[4 * j + 2 * half + 1], b1, swish));
      unsigned char* dst = sOut + (col / 64) * 8192 + row * 128 +
                           ((((col % 64) / 8) ^ (row % 8)) * 16) + qc * 2;
      *reinterpret_cast<uint32_t*>(dst) = v;
    }
  }
  fence_proxy_async();
  named_barrier_sync(2 + wg, 128);
  if ((tid & 127) == 0) {
    // This warpgroup's 64 pixels: half of a 128-wide row segment, or 64/bw
    // whole rows of a narrower rectangle.
    const int xs = s.bw == TM ? x0 + wg * 64 : x0;
    const int ys = s.bw == TM ? y0 : y0 + wg * (64 / s.bw);
    for (int h = 0; h < BN / 64; ++h) tma_store_4d(&map_out, sOut + h * 8192, n0 + h * 64, xs, ys, b);
    tma_store_commit_and_wait();
  }
}

template <int BN>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out, int batch,
                   int height, int width, int cin, int cout, int bw, int swish,
                   cudaStream_t stream) {
  const int bh = TM / bw;
  const ConvGeom s{cin, cout, bw, bh, (width + bw - 1) / bw, (height + bh - 1) / bh,
                   (cout + BN - 1) / BN};
  CUtensorMap mx, mw, mo;
  const cuuint64_t x_dims[4] = {(cuuint64_t)cin, (cuuint64_t)width, (cuuint64_t)height,
                                (cuuint64_t)batch};
  const cuuint64_t x_strides[3] = {(cuuint64_t)cin * 2, (cuuint64_t)width * cin * 2,
                                   (cuuint64_t)height * width * cin * 2};
  const cuuint32_t x_box[4] = {TK, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  const cuuint64_t w_dims[2] = {(cuuint64_t)cout, (cuuint64_t)9 * cin};
  const cuuint64_t w_strides[1] = {(cuuint64_t)cout * 2};
  const cuuint32_t w_box[2] = {64, TK};
  const int bws = bw < 64 ? bw : 64;  // a warpgroup's 64 pixels as a box
  const cuuint64_t o_dims[4] = {(cuuint64_t)cout, (cuuint64_t)width, (cuuint64_t)height,
                                (cuuint64_t)batch};
  const cuuint64_t o_strides[3] = {(cuuint64_t)cout * 2, (cuuint64_t)width * cout * 2,
                                   (cuuint64_t)height * width * cout * 2};
  const cuuint32_t o_box[4] = {64, (cuuint32_t)bws, (cuuint32_t)(64 / bws), 1};
  if (!encode_bf16_map(&mx, x, 4, x_dims, x_strides, x_box) ||
      !encode_bf16_map(&mw, w, 2, w_dims, w_strides, w_box) ||
      !encode_bf16_map(&mo, out, 4, o_dims, o_strides, o_box)) {
    return cudaErrorInvalidValue;
  }
  constexpr size_t smem = ConvLayout<BN>::bytes;
  auto kernel = conv3x3_sm90_kernel<BN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)s.tiles_n * s.tiles_w * s.tiles_h * batch;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(
      mx, mw, mo, static_cast<const __nv_bfloat16*>(bias), s, swish);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [B, H, W, Cin], w: [3, 3, Cin, Cout] (HWIO), bias: [Cout], out:
// [B, H, W, Cout], bf16, contiguous, 16-byte aligned. Needs Cin % 64 == 0,
// Cout % 8 == 0; the block's pixel rectangle is bw x (128 / bw) with bw a
// power of two in [1, 128], and its tile bn = 128 or 256 output channels.
// Returns a cudaError_t.
int ca_conv3x3_sm90_bf16(const void* x, const void* w, const void* bias, void* out, int batch,
                         int height, int width, int cin, int cout, int bw, int bn, int swish,
                         void* stream) {
  if (cin % TK != 0 || cout % 8 != 0 || bw < 1 || bw > TM || TM % bw != 0) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bn == 256) return launch<256>(x, w, bias, out, batch, height, width, cin, cout, bw, swish, st);
  if (bn == 128) return launch<128>(x, w, bias, out, batch, height, width, cin, cout, bw, swish, st);
  return cudaErrorInvalidValue;
}

const char* ca_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
