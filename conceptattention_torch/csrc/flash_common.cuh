// Shared by the flash-saliency kernels (csrc/flash_saliency.cu: K1, K3;
// csrc/flash_saliency_int8.cu: K1b): tile sizes, the segment mask of the
// fused sequence S = [txt | img | concept | pad], the mma.sync / ldmatrix /
// cp.async wrappers and the interleaved-pair RoPE rotation.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128, BK = 64, NT = 256;  // 8 warps x 16 query rows

struct Segments {
  int txt_len;      // end of the txt segment
  int joint_end;    // end of txt|img, start of the concept segment
  int concept_end;  // end of the real concepts; rows past it are padding
  int seq_len;      // S
  int cross;
  int self_attn;
};

Segments make_segments(int seq_len, int txt_len, int img_len, int concept_len, int cross,
                       int self_attn) {
  return Segments{txt_len, txt_len + img_len, txt_len + img_len + concept_len, seq_len,
                  cross, self_attn};
}

__device__ __forceinline__ bool allowed(const Segments& g, int qi, int ki) {
  if (qi < g.joint_end) return ki < g.joint_end;
  if (qi >= g.concept_end) return false;
  return (g.cross && ki >= g.txt_len && ki < g.joint_end) ||
         (g.self_attn && ki >= g.joint_end && ki < g.concept_end);
}

// Can any (q, k) pair of the rows [q0, q0+nq) and keys [k0, k0+nk) be unmasked?
__device__ __forceinline__ bool tile_reachable(const Segments& g, int q0, int nq,
                                               int k0, int nk) {
  const bool q_joint = q0 < g.joint_end;
  const bool q_concept = q0 + nq > g.joint_end && q0 < g.concept_end;
  const bool k_joint = k0 < g.joint_end;
  const bool k_img = k0 + nk > g.txt_len && k0 < g.joint_end;
  const bool k_concept = k0 + nk > g.joint_end && k0 < g.concept_end;
  return (q_joint && k_joint) ||
         (q_concept && ((g.cross && k_img) || (g.self_attn && k_concept)));
}

// Is every pair of the tile unmasked (so the tile needs no per-element mask)?
__device__ __forceinline__ bool tile_full(const Segments& g, int q0, int nq, int k0, int nk) {
  const int q1 = q0 + nq, k1 = k0 + nk;
  if (q1 <= g.joint_end) return k1 <= g.joint_end;
  if (q0 < g.joint_end || q1 > g.concept_end) return false;
  return (g.cross && k0 >= g.txt_len && k1 <= g.joint_end) ||
         (g.self_attn && k0 >= g.joint_end && k1 <= g.concept_end);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16x8 f32) += a (16x16 bf16, row-major) * b (16x8 bf16, column-major).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The rotation tables of eight consecutive channels of one row.
struct Rot8 {
  float c[8];
  float s[8];
};

__device__ __forceinline__ Rot8 load_rot8(const float* cos_p, const float* sin_p) {
  const float4 c0 = *reinterpret_cast<const float4*>(cos_p);
  const float4 c1 = *reinterpret_cast<const float4*>(cos_p + 4);
  const float4 s0 = *reinterpret_cast<const float4*>(sin_p);
  const float4 s1 = *reinterpret_cast<const float4*>(sin_p + 4);
  return Rot8{{c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w},
              {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w}};
}

// Eight consecutive channels of one row, rotated by the interleaved-pair
// tables (y[2i] = x[2i] cos[2i] + x[2i+1] sin[2i], y[2i+1] = x[2i+1]
// cos[2i+1] + x[2i] sin[2i+1]) and multiplied by `mul`, in f32, rounded to
// bf16.
__device__ __forceinline__ uint4 rotate8(uint4 x, const Rot8& t, float mul) {
  const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&x);
  uint4 y;
  uint32_t* yv = reinterpret_cast<uint32_t*>(&y);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float a = __bfloat162float(xv[i].x), b = __bfloat162float(xv[i].y);
    yv[i] = pack_bf16((a * t.c[2 * i] + b * t.s[2 * i]) * mul,
                      (b * t.c[2 * i + 1] + a * t.s[2 * i + 1]) * mul);
  }
  return y;
}

}  // namespace
