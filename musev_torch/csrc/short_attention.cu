// Multi-head self-attention over short packed rows, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _kernel behind short_attention_packed
// (musev_tpu/ops/pallas/short_attention.py), which runs attn1 and attn2 of
// every temporal transformer: rows of T <= 64 frames per pixel, q/k/v packed
// (N, T, C) straight from the fused QKV projection, C = n_heads * D.
// The Pallas kernel computes all heads in one program with a 0/1 lane mask,
// a TPU layout device; here a block owns one (row, head) pair and reads only
// that head's D columns, with the row stride given by the caller so the
// strided q/k/v views of the fused projection go in without copies.
//
// Bound. Each q/k/v element is read once and each output written once:
// 4*N*T*C*2 bytes, about 1.0 GB at the 576^2 top level (N = 31,104, T = 13,
// C = 320), 0.3 ms at 3.35 TB/s; the T*T*D multiply-adds per (row, head) are
// far below the tensor-core line, so the bound is memory. The design keeps the
// traffic at that minimum: the head's K and V (T x D, a few KB) are staged once
// in shared memory, each warp takes one query at a time with its lanes across
// the head's columns, the T logits are reduced with warp shuffles and the
// softmax over T is computed whole in fp32 registers (no online rescaling).
// Keys at positions >= kv_len are masked; outputs of those query rows are
// computed all the same and left to the caller to discard.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kMaxPairs = 4;  // bf16 pairs per lane: D <= 256

__device__ __forceinline__ float2 ld_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <int TMAX>
__global__ void __launch_bounds__(kWarps * 32)
    short_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      int n_heads, int T, int D, long long ld, int kv_len, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + T * D;

  const long long n = blockIdx.x / n_heads;
  const int h = blockIdx.x - (int)n * n_heads;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int half_d = D >> 1;
  const long long row0 = n * T;  // first (n, t) row of this block
  const long long col0 = (long long)h * D;

  for (int i = tid; i < T * half_d; i += kWarps * 32) {
    int tt = i / half_d;
    int c = (i - tt * half_d) * 2;
    long long g = (row0 + tt) * ld + col0 + c;
    *reinterpret_cast<uint32_t*>(Ks + tt * D + c) = *reinterpret_cast<const uint32_t*>(k + g);
    *reinterpret_cast<uint32_t*>(Vs + tt * D + c) = *reinterpret_cast<const uint32_t*>(v + g);
  }
  __syncthreads();

  const long long C = (long long)n_heads * D;
  for (int tq = warp; tq < T; tq += kWarps) {
    float2 qf[kMaxPairs];
    const __nv_bfloat16* qrow = q + (row0 + tq) * ld + col0;
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      int p = lane + 32 * i;
      qf[i] = p < half_d ? ld_pair(qrow + 2 * p) : make_float2(0.f, 0.f);
      qf[i].x *= scale_log2;
      qf[i].y *= scale_log2;
    }
    float s[TMAX];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < TMAX; ++j) {
      if (j < T) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxPairs; ++i) {
          int p = lane + 32 * i;
          if (p < half_d) {
            float2 kv = ld_pair(Ks + j * D + 2 * p);
            part = fmaf(qf[i].x, kv.x, fmaf(qf[i].y, kv.y, part));
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
        s[j] = j < kv_len ? part : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < TMAX; ++j) {
      if (j < T) {
        s[j] = exp2f(s[j] - mx);
        sum += s[j];
      }
    }
    const float inv = 1.f / sum;  // kv_len >= 1, so the max term gives sum >= 1
    __nv_bfloat16* orow = o + (row0 + tq) * C + col0;
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      int p = lane + 32 * i;
      if (p < half_d) {
        float ax = 0.f, ay = 0.f;
#pragma unroll
        for (int j = 0; j < TMAX; ++j) {
          if (j < T) {
            float2 vv = ld_pair(Vs + j * D + 2 * p);
            ax = fmaf(s[j], vv.x, ax);
            ay = fmaf(s[j], vv.y, ay);
          }
        }
        *reinterpret_cast<__nv_bfloat162*>(orow + 2 * p) =
            __floats2bfloat162_rn(ax * inv, ay * inv);
      }
    }
  }
}

template <int TMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, long long N,
                   int n_heads, int T, int D, long long ld, int kv_len, float scale,
                   cudaStream_t stream) {
  const size_t smem = (size_t)2 * T * D * sizeof(__nv_bfloat16);
  auto kernel = short_attn_kernel<TMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned int)(N * n_heads), kWarps * 32, smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(v), reinterpret_cast<__nv_bfloat16*>(o), n_heads,
      T, D, ld, kv_len, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q/k/v: (N, T, n_heads * D) bf16 with row stride ``ld`` elements and unit
// column stride; o: contiguous (N, T, n_heads * D). Returns 0, a cudaError_t,
// or -1 for an unsupported shape.
int musev_short_attention_bf16(const void* q, const void* k, const void* v, void* o,
                               long long N, int n_heads, int T, int D, long long ld,
                               int kv_len, float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 2 != 0 || D > 2 * 32 * kMaxPairs) return -1;
  if (kv_len < 1 || kv_len > T || N * n_heads >= (1LL << 31)) return -1;
  if (T <= 16) return launch<16>(q, k, v, o, N, n_heads, T, D, ld, kv_len, scale, st);
  if (T <= 32) return launch<32>(q, k, v, o, N, n_heads, T, D, ld, kv_len, scale, st);
  if (T <= 64) return launch<64>(q, k, v, o, N, n_heads, T, D, ld, kv_len, scale, st);
  return -1;
}

const char* musev_cuda_error_string(int err) {
  if (err == -1) return "unsupported shape";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
