// The temporal-rows pivot and its inverse, for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of scripts/bench_fused_transpose.py:
//   * _t_kernel     (K5): (b, T, HW, C) -> (b, HW, T, C);
//   * _t_gn_kernel  (K6): the same pivot with a fused fp32 per-(b, t, c)
//                         scale/shift, the GroupNorm apply of the temporal
//                         transformer: y = bf16(fp32(x) * scale + shift);
//   * _inv_kernel   (K7): (b, HW, T, C) -> (b, T, HW, C).
// Every temporal transformer runs K6 on its GroupNorm'd input to make the
// pixel-major rows of the packed temporal attention, and K7 on its output.
//
// Bound. Pure data movement: each element is read once and written once,
// 2 * b*T*HW*C * 2 bytes (bf16), 0.15 GB at the 576^2 top level of the
// 12-frame window batch (b 6, T 13, HW 5184, C 320), 0.05 ms at 3.35 TB/s; the
// K6 affine adds one fp32 multiply and add per element, far below any compute
// limit. So the bound is memory, and the design moves every byte once, in
// 16-byte vectors on both sides.
//
// Design. C is the minor, contiguous axis on both sides of either pivot, and
// output row (p, t) is input row (t, p), so one thread copies one 16-byte
// vector (8 bf16 or 4 fp32) of one row: neighbouring threads read and write
// neighbouring addresses, with no shared-memory staging. The TPU kernel's
// in-VMEM swapaxes is a TPU layout device and is not carried over. Each
// thread derives its (batch, a, b, c) position from its flat output index, so
// every HW is covered (the TPU kernel's hw // 128 grid leaves a ragged tail
// of pixels unwritten). The input is addressed by outer strides given by the
// caller (C contiguous), so a view needs no copy; the output is contiguous.
// Scale and shift are addressed by (batch, t) strides, so a scale broadcast
// over T (stride 0) needs no copy either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float affine(float x, float s, float h) {
  // multiply, then add, each rounded: no FMA, as the plain version computes it
  return __fadd_rn(__fmul_rn(x, s), h);
}

__device__ __forceinline__ uint4 apply_affine(uint4 v, const __nv_bfloat16*, const float* s,
                                              const float* h) {
  const float4 s0 = __ldg(reinterpret_cast<const float4*>(s));
  const float4 s1 = __ldg(reinterpret_cast<const float4*>(s + 4));
  const float4 h0 = __ldg(reinterpret_cast<const float4*>(h));
  const float4 h1 = __ldg(reinterpret_cast<const float4*>(h + 4));
  const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const float sh[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    p[i] = __floats2bfloat162_rn(affine(f.x, sc[2 * i], sh[2 * i]),
                                 affine(f.y, sc[2 * i + 1], sh[2 * i + 1]));
  }
  return v;
}

__device__ __forceinline__ uint4 apply_affine(uint4 v, const float*, const float* s,
                                              const float* h) {
  const float4 sc = __ldg(reinterpret_cast<const float4*>(s));
  const float4 sh = __ldg(reinterpret_cast<const float4*>(h));
  float4 f = *reinterpret_cast<float4*>(&v);
  f.x = affine(f.x, sc.x, sh.x);
  f.y = affine(f.y, sc.y, sh.y);
  f.z = affine(f.z, sc.z, sh.z);
  f.w = affine(f.w, sc.w, sh.w);
  return *reinterpret_cast<uint4*>(&f);
}

// out (nbatch, na, nb, C) contiguous <- in[batch * s_batch + a * s_a + b * s_b + c].
// With AFFINE, out = in * scale + shift, scale/shift at batch * ss_batch +
// b * ss_t + c (b is the time index: only the forward pivot takes them).
template <typename T, bool AFFINE>
__global__ void __launch_bounds__(kThreads)
    relayout_kernel(const T* __restrict__ in, T* __restrict__ out,
                    const float* __restrict__ scale, const float* __restrict__ shift,
                    uint32_t na, uint32_t nb, uint32_t cv, long long s_batch, long long s_a,
                    long long s_b, long long ss_batch, long long ss_t, uint32_t total) {
  constexpr int kVec = 16 / sizeof(T);
  const uint32_t v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= total) return;
  const uint32_t row = v / cv;
  const uint32_t c = (v - row * cv) * kVec;
  const uint32_t r2 = row / nb;
  const uint32_t ib = row - r2 * nb;
  const uint32_t ibatch = r2 / na;
  const uint32_t ia = r2 - ibatch * na;
  uint4 x = __ldg(reinterpret_cast<const uint4*>(in + ibatch * s_batch + ia * s_a +
                                                 ib * s_b + c));
  if constexpr (AFFINE) {
    const long long so = ibatch * ss_batch + ib * ss_t + c;
    x = apply_affine(x, in, scale + so, shift + so);
  }
  reinterpret_cast<uint4*>(out)[v] = x;
}

template <typename T>
int launch(const void* in, void* out, const float* scale, const float* shift, int nbatch,
           int na, int nb, int C, long long s_batch, long long s_a, long long s_b,
           long long ss_batch, long long ss_t, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (nbatch <= 0 || na <= 0 || nb <= 0 || C <= 0 || C % kVec != 0) return -1;
  const long long total = (long long)nbatch * na * nb * (C / kVec);
  if (total >= (1LL << 32) - kThreads) return -1;
  const unsigned int blocks = (unsigned int)((total + kThreads - 1) / kThreads);
  const T* x = reinterpret_cast<const T*>(in);
  T* y = reinterpret_cast<T*>(out);
  if (scale != nullptr) {
    relayout_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        x, y, scale, shift, na, nb, C / kVec, s_batch, s_a, s_b, ss_batch, ss_t,
        (uint32_t)total);
  } else {
    relayout_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
        x, y, nullptr, nullptr, na, nb, C / kVec, s_batch, s_a, s_b, 0, 0, (uint32_t)total);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward pivot, (b, T, HW, C) -> contiguous (b, HW, T, C). x strides
// (batch, time, pixel) in elements, C contiguous, 16-byte aligned. scale and
// shift are null (K5) or fp32 with strides (batch, time), C contiguous (K6).
// elem_bytes is 2 (bf16) or 4 (fp32). Returns 0, a cudaError_t, or -1 for an
// unsupported shape.
int musev_pivot_rows(const void* x, void* y, const void* scale, const void* shift,
                     int elem_bytes, int B, int T, int HW, int C, long long x_sb,
                     long long x_st, long long x_sp, long long s_sb, long long s_st,
                     void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const float* sc = reinterpret_cast<const float*>(scale);
  const float* sh = reinterpret_cast<const float*>(shift);
  if ((sc == nullptr) != (sh == nullptr)) return -1;
  if (elem_bytes == 2)
    return launch<__nv_bfloat16>(x, y, sc, sh, B, HW, T, C, x_sb, x_sp, x_st, s_sb, s_st, st);
  if (elem_bytes == 4)
    return launch<float>(x, y, sc, sh, B, HW, T, C, x_sb, x_sp, x_st, s_sb, s_st, st);
  return -1;
}

// Inverse pivot, (b, HW, T, C) -> contiguous (b, T, HW, C). y strides
// (batch, pixel, time) in elements, C contiguous, 16-byte aligned.
int musev_unpivot_rows(const void* y, void* x, int elem_bytes, int B, int HW, int T, int C,
                       long long y_sb, long long y_sp, long long y_st, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (elem_bytes == 2)
    return launch<__nv_bfloat16>(y, x, nullptr, nullptr, B, T, HW, C, y_sb, y_st, y_sp, 0, 0,
                                 st);
  if (elem_bytes == 4)
    return launch<float>(y, x, nullptr, nullptr, B, T, HW, C, y_sb, y_st, y_sp, 0, 0, st);
  return -1;
}

const char* musev_cuda_error_string(int err) {
  if (err == -1) return "unsupported shape or dtype";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
