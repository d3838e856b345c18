// LayerNorm of bf16 rows in one pass, with an optional affine and an
// optional per-batch modulation, for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. The JAX package leaves the CogVideoX block's
//   norms (models/video/dit.py: `_ln`, `_norm_zero`, `_qkv_heads_ln`) to XLA,
//   which fuses each into one pass; eager PyTorch ran each as about 14 ATen
//   ops over f32 temporaries. This kernel is that one pass.
//
// What it computes, per row x of width D (PyTorch's rounding points):
//   mean = f32 sum(x) * (1/D);  var = f32 sum((x - mean)^2) * (1/D);
//   t = (x - mean) * rsqrt(var + eps), then t * w, then t + b (each in f32,
//   w and b optional); n = bf16(t);
//   with a modulation: n = bf16(n * bf16(1 + scale[batch])), then
//   n = bf16(n + shift[batch]).
// Each operation rounds on its own (no contraction into FMAs), so only the
// order of the two row sums differs from the eager version.
//
// Rows: a launch covers `nstreams` (1 or 2) tensors of the same shape. A row
// is (batch, m, r); its input starts at x + batch*xs_b + m*xs_m + r*xs_r and
// its output at y + batch*ys_b + m*ys_m + r*ys_r, D contiguous elements
// each. LayerNormZero is (B, L, 1); the q/k norm reads the qkv GEMM's output
// [B, L, 3, H, hd] as (B, L, H) rows of q (stream 0) and of k (stream 1,
// input offset by one H*hd block) and writes each as [B, H, L, hd].
//
// What bounds it on an H100: bytes. It reads 2 bytes and writes 2 bytes an
// element and does about ten f32 operations on it, far below the 295
// operations a byte where the tensor cores would start to bound it. The
// design moves each activation byte once and keeps enough of them in
// flight: 16-byte loads, neighbouring threads on neighbouring addresses; a
// row spread over up to 128 threads (3 vectors a thread at D = 3072, a block
// a row; 4 threads of 2 vectors at D = 64; D up to 3072) and kept in registers in f32
// between the mean, the variance and the output passes; the next row's
// loads issued before this row's reductions; blocks of 128 threads at some
// 60 registers, so that several share a multiprocessor and one block's
// loads overlap another's arithmetic; w and b (as f32) and 1 + scale and
// shift (as bf16) staged once a block in shared memory, so the per-row
// parameter reads come from shared memory and not from L2; the modulation
// in bf16x2 operations, which round a product or sum of bf16 operands once,
// as f32 arithmetic rounded to bf16 does (f32 holds 2 * 8 + 2 bits).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int NT = 128;        // threads a block
constexpr int PASSES = 8;      // row groups a block takes, one after another
constexpr int MAX_WIDTH = 3072;  // CogVideoX-5b's hidden size: 36 KB of parameters a block

struct Stream {
  const __nv_bfloat16* x;
  __nv_bfloat16* y;
  const __nv_bfloat16* w;  // [D] or null
  const __nv_bfloat16* b;  // [D] or null
};

struct Rows {
  Stream s[2];
  const __nv_bfloat16* scale;  // row `batch` at scale + batch * scale_stride, or null
  const __nv_bfloat16* shift;
  long long scale_stride, shift_stride;
  long long xs_b, xs_m, xs_r, ys_b, ys_m, ys_r;
  int m, r, d;
  float eps;
};

__device__ __forceinline__ void unpack8(const uint4& raw, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// The sum of v over the TPR threads of a row, in every one of them. Above a
// warp, through `red` (one float a warp): the caller alternates two slots,
// so a warp that runs ahead never overwrites what a slower one still reads.
template <int TPR>
__device__ __forceinline__ float row_sum(float v, float* red) {
#pragma unroll
  for (int o = (TPR < 32 ? TPR : 32) / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  if constexpr (TPR > 32) {
    constexpr int W = TPR / 32;  // warps a row
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) red[warp] = v;
    __syncthreads();
    const int first = warp / W * W;
    v = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) v += red[first + i];
  }
  return v;
}

// TPR threads a row (a power of two, 4..128), VPL 16-byte vectors a thread
// at most; the row stays in registers in f32 between its three passes, and
// the next row's vectors are in flight meanwhile.
template <int TPR, int VPL>
__global__ void __launch_bounds__(NT)
layer_norm_rows_kernel(Rows a) {
  // f32 w and b ([D] each), then bf16 1 + scale and shift ([D] each)
  extern __shared__ __align__(16) float4 params[];
  __shared__ float red[2][NT / 32];
  constexpr int GROUP = NT / TPR;  // rows a block holds at once
  const Stream st = a.s[blockIdx.z];
  const int batch = blockIdx.y, d = a.d, nvec = d / 8, rows = a.m * a.r;
  const int slot = threadIdx.x / TPR, l = threadIdx.x % TPR;
  const int first = blockIdx.x * (GROUP * PASSES) + slot;  // this thread's row in pass 0

  // Row `row`'s vectors of this thread, zeros where there is no row or vector.
  auto load = [&](int row, uint4* raw) {
    const bool live = row < rows;
    const uint4* xr = reinterpret_cast<const uint4*>(
        st.x + batch * a.xs_b + (live ? row / a.r : 0) * a.xs_m + (live ? row % a.r : 0) * a.xs_r);
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = j * TPR + l;
      raw[j] = (live && c < nvec) ? __ldg(xr + c) : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  uint4 next[VPL];
  load(first, next);  // in flight while the parameters are staged

  const bool has_w = st.w != nullptr, has_b = st.b != nullptr, has_mod = a.scale != nullptr;
  float4* s_w = params;            // two float4 a vector
  float4* s_b = params + 2 * nvec;
  uint4* s_m = reinterpret_cast<uint4*>(params + 4 * nvec);
  uint4* s_s = s_m + nvec;
  for (int c = threadIdx.x; c < nvec; c += NT) {
    float f[8];
    if (has_w) {
      unpack8(__ldg(reinterpret_cast<const uint4*>(st.w) + c), f);
      s_w[2 * c] = make_float4(f[0], f[1], f[2], f[3]);
      s_w[2 * c + 1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    if (has_b) {
      unpack8(__ldg(reinterpret_cast<const uint4*>(st.b) + c), f);
      s_b[2 * c] = make_float4(f[0], f[1], f[2], f[3]);
      s_b[2 * c + 1] = make_float4(f[4], f[5], f[6], f[7]);
    }
    if (has_mod) {
      unpack8(__ldg(reinterpret_cast<const uint4*>(a.scale + batch * a.scale_stride) + c), f);
      uint4 one_plus;
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&one_plus);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = __floats2bfloat162_rn(__fadd_rn(1.f, f[2 * e]), __fadd_rn(1.f, f[2 * e + 1]));
      s_m[c] = one_plus;
      s_s[c] = __ldg(reinterpret_cast<const uint4*>(a.shift + batch * a.shift_stride) + c);
    }
  }
  __syncthreads();

  const float inv_d = 1.f / (float)d;
#pragma unroll 1
  for (int p = 0; p < PASSES; ++p) {
    const int row = first + p * GROUP;
    const bool live = row < rows;  // dead rows still join the reductions
    float v[VPL * 8];
#pragma unroll
    for (int j = 0; j < VPL; ++j) unpack8(next[j], v + 8 * j);
    if (p + 1 < PASSES) load(row + GROUP, next);  // the next row in flight meanwhile

    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < VPL * 8; ++e) sum = __fadd_rn(sum, v[e]);  // zeros beyond the row
    const float mean = __fmul_rn(row_sum<TPR>(sum, red[0]), inv_d);
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      if (j * TPR + l >= nvec) continue;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float c = __fsub_rn(v[8 * j + e], mean);
        sq = __fadd_rn(sq, __fmul_rn(c, c));
      }
    }
    const float var = __fmul_rn(row_sum<TPR>(sq, red[1]), inv_d);
    const float rstd = rsqrtf(__fadd_rn(var, a.eps));
    if (!live) continue;

    uint4* yr = reinterpret_cast<uint4*>(st.y + batch * a.ys_b + row / a.r * a.ys_m +
                                         row % a.r * a.ys_r);
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int c = j * TPR + l;
      if (c >= nvec) continue;
      float u[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) u[e] = __fmul_rn(__fsub_rn(v[8 * j + e], mean), rstd);
      if (has_w) {
        const float4 w0 = s_w[2 * c], w1 = s_w[2 * c + 1];
        const float w8[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) u[e] = __fmul_rn(u[e], w8[e]);
      }
      if (has_b) {
        const float4 b0 = s_b[2 * c], b1 = s_b[2 * c + 1];
        const float b8[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) u[e] = __fadd_rn(u[e], b8[e]);
      }
      uint4 out;
      __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = __floats2bfloat162_rn(u[2 * e], u[2 * e + 1]);
      if (has_mod) {
        // one rounding each, as the header says
        const uint4 mq = s_m[c], sq4 = s_s[c];
        const __nv_bfloat162* m2 = reinterpret_cast<const __nv_bfloat162*>(&mq);
        const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(&sq4);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = __hadd2_rn(__hmul2_rn(o[e], m2[e]), s2[e]);
      }
      yr[c] = out;
    }
  }
}

template <int TPR, int VPL>
cudaError_t launch(const Rows& a, int batch, int nstreams, cudaStream_t st) {
  constexpr int rows_per_block = NT / TPR * PASSES;
  const long long blocks = ((long long)a.m * a.r + rows_per_block - 1) / rows_per_block;
  const dim3 grid((unsigned)blocks, (unsigned)batch, (unsigned)nstreams);
  const size_t smem = (size_t)a.d * (2 * sizeof(float) + 2 * sizeof(__nv_bfloat16));
  layer_norm_rows_kernel<TPR, VPL><<<grid, NT, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Normalise `nstreams` (1 or 2) bf16 tensors of [batch, m, r] rows of width
// d (d % 8 == 0, d <= 3072) as the header says. x0/y0/w0/b0 are stream 0's
// input, output, affine scale and bias (w and b may be null), x1.. stream
// 1's (ignored with one stream). scale and shift are both null or both
// given, each row `batch` at its stride. Strides are in elements, multiples
// of 8; every pointer is 16-byte aligned. Returns a cudaError_t.
int ca_layer_norm_bf16(const void* x0, void* y0, const void* w0, const void* b0,
                       const void* x1, void* y1, const void* w1, const void* b1, int nstreams,
                       const void* scale, long long scale_stride, const void* shift,
                       long long shift_stride, int batch, int m, int r, int d,
                       long long xs_b, long long xs_m, long long xs_r, long long ys_b,
                       long long ys_m, long long ys_r, float eps, void* stream) {
  if (d <= 0 || d % 8 != 0 || d > MAX_WIDTH || nstreams < 1 || nstreams > 2 || batch < 1 ||
      batch > 65535 || m < 1 || r < 1 || (long long)m * r > 0x7fffffffLL ||
      (scale == nullptr) != (shift == nullptr))
    return cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  Rows a;
  a.s[0] = {static_cast<const bf*>(x0), static_cast<bf*>(y0), static_cast<const bf*>(w0),
            static_cast<const bf*>(b0)};
  a.s[1] = nstreams == 2 ? Stream{static_cast<const bf*>(x1), static_cast<bf*>(y1),
                                  static_cast<const bf*>(w1), static_cast<const bf*>(b1)}
                         : a.s[0];
  a.scale = static_cast<const bf*>(scale);
  a.shift = static_cast<const bf*>(shift);
  a.scale_stride = scale_stride;
  a.shift_stride = shift_stride;
  a.xs_b = xs_b, a.xs_m = xs_m, a.xs_r = xs_r, a.ys_b = ys_b, a.ys_m = ys_m, a.ys_r = ys_r;
  a.m = m, a.r = r, a.d = d, a.eps = eps;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Two vectors a thread up to 128 threads a row, then 3.
  const int nvec = d / 8;
  if (nvec <= 8) return launch<4, 2>(a, batch, nstreams, st);
  if (nvec <= 16) return launch<8, 2>(a, batch, nstreams, st);
  if (nvec <= 32) return launch<16, 2>(a, batch, nstreams, st);
  if (nvec <= 64) return launch<32, 2>(a, batch, nstreams, st);
  if (nvec <= 128) return launch<64, 2>(a, batch, nstreams, st);
  if (nvec <= 256) return launch<128, 2>(a, batch, nstreams, st);
  return launch<128, 3>(a, batch, nstreams, st);
}

const char* ca_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
