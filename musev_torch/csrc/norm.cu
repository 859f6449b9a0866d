// GroupNorm (optionally followed by SiLU) and LayerNorm over the channel axis
// of channels-last activations, for Hopper (sm_90a): bf16 in and out, the
// statistics and the affine in fp32 registers.
//
// Replaces no TPU kernel: the JAX package leaves its norms to XLA, which
// fuses each into the neighbouring elementwise work. The port's plain
// composition (ops/kernels/norm.py, group_norm_plain / layer_norm_plain) makes
// a float32 copy of x, takes var_mean, applies the affine in float32 and casts
// back, then runs SiLU as one more bf16 pass: about 28 bytes moved per bf16
// element for GroupNorm + SiLU and 20 for LayerNorm, over some ten launches.
//
// Bound. Memory: a few fp32 operations per element against 2 bytes read and
// 2 written. The least traffic is one bf16 read and one bf16 write of x.
// GroupNorm's statistics cover a whole (sample, group) before any element
// can be written, and x is far larger than the L2 cache at the sites that
// matter (0.26 GB at the UNet's top level), so GroupNorm reads x twice: 6
// bytes per element, two thirds of the bound's share at best. LayerNorm
// keeps its row in registers: 4 bytes per element.
//
// Design, GroupNorm over an (N, M, C) view (M every axis between the sample
// and the channels; C a multiple of 8, cut into G groups of cg channels, and
// cg need not be a multiple of the vector width):
//   * gn_stats_kernel: a block takes a run of rows of one sample and all C
//     channels. Thread (ry, v) owns channel vector v (16 bytes: 8 bf16) and
//     rows ry, ry + r, ... (r thread rows, the caller's plan); it keeps a
//     Welford (mean, M2) per channel in registers, four rows in flight. The
//     block then merges its threads' partials through shared memory (Chan's
//     formula about the merged mean: first per channel over the thread rows,
//     then per group over its channels) and writes one (mean, M2) per group
//     to a small float32 scratch.
//   * gn_finalize_kernel: one warp per (sample, group) merges the blocks'
//     partials the same way, in a fixed order (no atomics: the result is
//     the same on every run), and writes the per-channel fp32 scale =
//     w * rsqrt(var + eps) and shift = b - mean * scale, as the plain
//     version forms them. The temporal transformer takes exactly these
//     (group_norm_scale_shift) into the pivot's fused apply.
//   * gn_apply_kernel: thread (ry, v) holds its 8 channels' scale and shift in
//     registers and writes silu?(x * scale + shift) in bf16, four rows in
//     flight; its blocks take x from the end, which the statistics read last.
// The thread rows r and the splits adapt to the input alone and are planned
// by the caller (ops/kernels/norm.py plan_rows): enough blocks for several
// waves over the card's SMs, however few samples there are, and at most 1024
// partials per (sample, group) to merge; the entry points refuse a plan whose
// block holds more than kBlockElems elements.
//
// Design, LayerNorm over rows of C (C <= 2048): a row to the fewest lanes
// that hold it in registers (8 lanes for 320 bf16 channels, so a warp takes
// 4 rows at once; 32 for 1280), each lane VPL 16-byte vectors of it; the
// lanes sum them for the mean, then the squared deviations for the variance
// (two passes over registers, no cancellation), and write
// (x - mean) * rstd * w + b in bf16.
//
// The weights may be bf16 (inference) or fp32 (the float32 masters of
// training under autocast; a flag): they are read through fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// x elements a GroupNorm block's threads hold at once (r rows of C), and
// its largest C: the statistics block's shared partials
constexpr int kBlockElems = 4096;
constexpr int kUnroll = 4;  // rows each thread has in flight
constexpr int kLnThreads = 256;
constexpr int kV = 8;                           // bf16 elements in a 16-byte vector
constexpr int kMaxThreads = kBlockElems / kV;  // a GroupNorm block's

struct Vec {
  static __device__ __forceinline__ void unpack(const uint4& raw, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return raw;
  }
};

__device__ __forceinline__ float param(const void* p, int w_bf16, int i) {
  return w_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
                : reinterpret_cast<const float*>(p)[i];
}

// fp32 values [c, c + kV) (c a multiple of kV, p 16-byte aligned)
__device__ __forceinline__ void load_f32(const float* p, int c, float* f) {
#pragma unroll
  for (int i = 0; i < kV; i += 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p + c + i));
    f[i] = t.x;
    f[i + 1] = t.y;
    f[i + 2] = t.z;
    f[i + 3] = t.w;
  }
}

// params [c, c + kV) as fp32, bf16 or fp32 in memory (w_bf16)
__device__ __forceinline__ void params(const void* p, int w_bf16, int c, float* f) {
  if (w_bf16)
    Vec::unpack(__ldg(reinterpret_cast<const uint4*>(reinterpret_cast<const __nv_bfloat16*>(p) +
                                                     c)),
                f);
  else
    load_f32(reinterpret_cast<const float*>(p), c, f);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum over each aligned group of `lanes` lanes (a power of two), every
// lane of the warp taking part
__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Per-group (mean, M2) of rows [m0, m1) of sample blockIdx.y, block
// blockIdx.x, into part[(n * gridDim.x + block) * G + g].
__global__ void __launch_bounds__(kMaxThreads)
    gn_stats_kernel(const __nv_bfloat16* __restrict__ x, float2* __restrict__ part, int M, int C,
                    int cg, int rows_per_block, long long s_n, long long s_m) {
  constexpr int V = kV;
  __shared__ float s_mean[kBlockElems];
  __shared__ float s_m2[kBlockElems];
  const int cv = C / V;
  const int r = blockDim.x / cv;
  const int ry = threadIdx.x / cv;
  const int vi = threadIdx.x - ry * cv;
  const int n = blockIdx.y;
  const int m0 = blockIdx.x * rows_per_block;
  const int m1 = min(M, m0 + rows_per_block);
  const __nv_bfloat16* base = x + n * s_n + (long long)vi * V;

  float mean[V], m2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) mean[i] = m2[i] = 0.f;
  int k = 0;
  for (int m = m0 + ry; m < m1; m += r * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (m + u * r < m1)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(base + (long long)(m + u * r) * s_m));
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (m + u * r >= m1) break;
      float f[V];
      Vec::unpack(raw[u], f);
      const float inv = __frcp_rn((float)(++k));
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = f[i] - mean[i];
        mean[i] = fmaf(d, inv, mean[i]);
        m2[i] = fmaf(d, f[i] - mean[i], m2[i]);
      }
    }
  }
  // the threads' partials, [i][thread]: channel vi * V + i of thread row ry
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s_mean[i * blockDim.x + threadIdx.x] = mean[i];
    s_m2[i * blockDim.x + threadIdx.x] = m2[i];
  }
  __syncthreads();

  // per channel over the r thread rows (Chan: the channel's mean, then M2
  // about it); thread row ry took base + (ry < extra) rows
  const int rows = m1 - m0, base_rows = rows / r, extra = rows - base_rows * r;
  // (the block has at least C / V threads, so V channels a thread at most)
  float cmean[V], cm2[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int t = threadIdx.x + j * blockDim.x;
    if (t >= C) break;
    const int i = t / cv, v = t - i * cv, col = i * blockDim.x + v;
    float sm = 0.f;
    for (int q = 0; q < r; ++q) sm += (base_rows + (q < extra)) * s_mean[col + q * cv];
    const float mu = sm / rows;
    float acc = 0.f;
    for (int q = 0; q < r; ++q) {
      const float d = s_mean[col + q * cv] - mu;
      acc += s_m2[col + q * cv] + (base_rows + (q < extra)) * d * d;
    }
    cmean[j] = mu;
    cm2[j] = acc;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int t = threadIdx.x + j * blockDim.x;
    if (t >= C) break;
    const int i = t / cv, c = (t - i * cv) * V + i;
    s_mean[c] = cmean[j];
    s_m2[c] = cm2[j];
  }
  __syncthreads();

  // per group over its cg channels, each of `rows` elements
  const int G = C / cg;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float sm = 0.f;
    for (int c = g * cg; c < (g + 1) * cg; ++c) sm += s_mean[c];
    const float mu = sm / cg;
    float acc = 0.f;
    for (int c = g * cg; c < (g + 1) * cg; ++c) {
      const float d = s_mean[c] - mu;
      acc += s_m2[c] + rows * d * d;
    }
    part[((long long)n * gridDim.x + blockIdx.x) * G + g] = make_float2(mu, acc);
  }
}

// One warp per (sample, group): merges the S blocks' partials and writes the
// group's channels' fp32 scale and shift, (N, C) each.
__global__ void __launch_bounds__(256)
    gn_finalize_kernel(const float2* __restrict__ part, const void* w, const void* b,
                       int w_bf16, float* __restrict__ scale, float* __restrict__ shift, int N,
                       int S, int M, int C, int cg, int rows_per_block, float eps) {
  const int G = C / cg;
  const int wid = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (wid >= N * G) return;
  const int n = wid / G, g = wid - n * G;
  const float2* p = part + (long long)n * S * G + g;
  float s = 0.f;
  for (int i = lane; i < S; i += 32) {
    const int rows = min(M, (i + 1) * rows_per_block) - i * rows_per_block;
    s += rows * p[(long long)i * G].x;
  }
  const float mean = warp_sum(s) / (float)M;
  float q = 0.f;
  for (int i = lane; i < S; i += 32) {
    const int rows = min(M, (i + 1) * rows_per_block) - i * rows_per_block;
    const float2 pi = p[(long long)i * G];
    const float d = pi.x - mean;
    q += pi.y + (float)rows * cg * d * d;
  }
  const float rstd = rsqrtf(warp_sum(q) / ((float)M * cg) + eps);
  for (int c = g * cg + lane; c < (g + 1) * cg; c += 32) {
    const float sc = rstd * param(w, w_bf16, c);
    scale[(long long)n * C + c] = sc;
    shift[(long long)n * C + c] = param(b, w_bf16, c) - mean * sc;
  }
}

// y (N, M, C) contiguous = silu?(x * scale + shift), scale/shift (N, C) fp32.
template <bool SILU>
__global__ void __launch_bounds__(kMaxThreads)
    gn_apply_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y,
                    const float* __restrict__ scale, const float* __restrict__ shift, int M,
                    int C, int rows_per_block, long long s_n, long long s_m) {
  constexpr int V = kV;
  const int cv = C / V;
  const int r = blockDim.x / cv;
  const int ry = threadIdx.x / cv;
  const int vi = threadIdx.x - ry * cv;
  // the blocks walk x backwards: the statistics pass read its end last, so
  // that part is the likeliest to be in L2 still
  const int n = gridDim.y - 1 - blockIdx.y;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * rows_per_block;
  const int m1 = min(M, m0 + rows_per_block);
  float sc[V], sh[V];
  load_f32(scale + (long long)n * C, vi * V, sc);
  load_f32(shift + (long long)n * C, vi * V, sh);
  const __nv_bfloat16* xb = x + n * s_n + (long long)vi * V;
  __nv_bfloat16* yb = y + (long long)n * M * C + (long long)vi * V;
  for (int m = m0 + ry; m < m1; m += r * kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (m + u * r < m1)
        raw[u] = __ldg(reinterpret_cast<const uint4*>(xb + (long long)(m + u * r) * s_m));
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (m + u * r >= m1) break;
      float f[V];
      Vec::unpack(raw[u], f);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float t = fmaf(f[i], sc[i], sh[i]);
        if constexpr (SILU) t = t / (1.f + __expf(-t));
        f[i] = t;
      }
      *reinterpret_cast<uint4*>(yb + (long long)(m + u * r) * C) = Vec::pack(f);
    }
  }
}

// LayerNorm of `rows` rows of C into y, contiguous (rows, C): a row per
// group of `lanes` lanes (a power of two), each lane holding VPL vectors of
// it, 32 / lanes rows a warp at once.
template <int VPL>
__global__ void __launch_bounds__(kLnThreads)
    ln_rows_kernel(const __nv_bfloat16* __restrict__ x, __nv_bfloat16* __restrict__ y,
                   const void* w, const void* b, int w_bf16, long long rows, int C,
                   long long s_row, float eps, int lanes) {
  constexpr int V = kV;
  const int cv = C / V;
  const int lane = threadIdx.x & 31, sub = lane & (lanes - 1);
  const int per_warp = 32 / lanes;
  const long long step = (long long)gridDim.x * (kLnThreads / 32) * per_warp;
  for (long long first = (((long long)blockIdx.x * kLnThreads + threadIdx.x) >> 5) * per_warp;
       first < rows; first += step) {
    const long long row = first + lane / lanes;
    const bool live = row < rows;
    float f[VPL][V];
    const __nv_bfloat16* xr = x + row * s_row;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int v = j * lanes + sub;
      if (live && v < cv) {
        Vec::unpack(__ldg(reinterpret_cast<const uint4*>(xr + v * V)), f[j]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) f[j][i] = 0.f;
      }
    }
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j)
#pragma unroll
      for (int i = 0; i < V; ++i) s += f[j][i];
    const float mean = group_sum(s, lanes) / C;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j)
      if (j * lanes + sub < cv)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = f[j][i] - mean;
          q = fmaf(d, d, q);
        }
    const float rstd = rsqrtf(group_sum(q, lanes) / C + eps);
    __nv_bfloat16* yr = y + row * C;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int v = j * lanes + sub;
      if (live && v < cv) {
        float wv[V], bv[V];
        params(w, w_bf16, v * V, wv);
        params(b, w_bf16, v * V, bv);
#pragma unroll
        for (int i = 0; i < V; ++i) f[j][i] = fmaf((f[j][i] - mean) * rstd, wv[i], bv[i]);
        *reinterpret_cast<uint4*>(yr + v * V) = Vec::pack(f[j]);
      }
    }
  }
}

// Whether the shape and the caller's plan fit: blocks of r >= 1 thread rows
// of C / kV threads, at most kBlockElems elements, `rows` rows each.
bool gn_plan_ok(int N, int M, int C, int G, int r, int rows) {
  return N > 0 && N <= 65535 && M > 0 && C > 0 && C % kV == 0 && G > 0 && C % G == 0 &&
         r > 0 && (long long)r * C <= kBlockElems && rows > 0;
}

int scale_shift(const void* x, const void* w, const void* b, int w_bf16, float2* part,
                float* scale, float* shift, int N, int M, int C, int G, long long s_n,
                long long s_m, int r, int rows_stats, float eps, cudaStream_t stream) {
  if (!gn_plan_ok(N, M, C, G, r, rows_stats)) return -1;
  const int S = (M + rows_stats - 1) / rows_stats;
  gn_stats_kernel<<<dim3(S, N), r * (C / kV), 0, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), part, M, C, C / G, rows_stats, s_n, s_m);
  const int warps = N * G;
  gn_finalize_kernel<<<(warps + 7) / 8, 256, 0, stream>>>(part, w, b, w_bf16, scale, shift, N,
                                                          S, M, C, C / G, rows_stats, eps);
  return (int)cudaGetLastError();
}

template <int VPL>
void launch_ln(const void* x, void* y, const void* w, const void* b, int w_bf16, long long rows,
               int C, long long s_row, float eps, int lanes, int max_blocks,
               cudaStream_t stream) {
  const long long per_block = (kLnThreads / 32) * (32 / lanes);
  const long long need = (rows + per_block - 1) / per_block;
  const int blocks = need < max_blocks ? (int)need : max_blocks;
  ln_rows_kernel<VPL><<<blocks, kLnThreads, 0, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), reinterpret_cast<__nv_bfloat16*>(y), w, b,
      w_bf16, rows, C, s_row, eps, lanes);
}

}  // namespace

extern "C" {

// GroupNorm statistics of bf16 x, an (N, M, C) view with strides (s_n, s_m,
// 1) in elements and 16-byte aligned rows, as fp32 (N, C) scale and shift.
// The plan: blocks of r thread rows (r * C <= 4096), rows_stats rows each;
// part is fp32 scratch of N * ceil(M / rows_stats) * G * 2 floats. The
// weights are bf16 (w_bf16 = 1) or fp32. Returns 0, a cudaError_t, or -1 for
// an unsupported shape or plan.
int musev_group_norm_scale_shift(const void* x, const void* w, const void* b, int w_bf16,
                                 void* part, float* scale, float* shift, int N, int M, int C,
                                 int G, long long s_n, long long s_m, int r, int rows_stats,
                                 float eps, void* stream) {
  return scale_shift(x, w, b, w_bf16, reinterpret_cast<float2*>(part), scale, shift, N, M, C, G,
                     s_n, s_m, r, rows_stats, eps, reinterpret_cast<cudaStream_t>(stream));
}

// GroupNorm (and SiLU where silu != 0) of x as above into bf16 y, contiguous
// (N, M, C), the apply's blocks rows_apply rows each; scale and shift
// receive the fp32 (N, C) affine on the way.
int musev_group_norm(const void* x, void* y, const void* w, const void* b, int w_bf16,
                     void* part, float* scale, float* shift, int N, int M, int C, int G,
                     long long s_n, long long s_m, int r, int rows_stats, int rows_apply,
                     float eps, int silu, void* stream) {
  if (!gn_plan_ok(N, M, C, G, r, rows_apply)) return -1;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int err = scale_shift(x, w, b, w_bf16, reinterpret_cast<float2*>(part), scale, shift, N,
                              M, C, G, s_n, s_m, r, rows_stats, eps, st);
  if (err) return err;
  const dim3 grid((M + rows_apply - 1) / rows_apply, N);
  const __nv_bfloat16* xt = reinterpret_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* yt = reinterpret_cast<__nv_bfloat16*>(y);
  const int threads = r * (C / kV);
  if (silu)
    gn_apply_kernel<true><<<grid, threads, 0, st>>>(xt, yt, scale, shift, M, C, rows_apply, s_n,
                                                    s_m);
  else
    gn_apply_kernel<false><<<grid, threads, 0, st>>>(xt, yt, scale, shift, M, C, rows_apply,
                                                     s_n, s_m);
  return (int)cudaGetLastError();
}

// LayerNorm over the last axis of `rows` rows of C bf16 (row stride s_row in
// elements, 16-byte aligned) into y, contiguous (rows, C), on at most
// max_blocks blocks of 8 warps. Rows take the fewest lanes (a power of two,
// at most 32) that hold them in 64 fp32 registers a lane: 8 lanes a row of
// 320 channels (5 vectors each, 4 rows a warp), 16 for 640, 32 for 1280.
int musev_layer_norm(const void* x, void* y, const void* w, const void* b, int w_bf16,
                     long long rows, int C, long long s_row, float eps, int max_blocks,
                     void* stream) {
  constexpr int kMaxVpl = 64 / kV;
  if (rows <= 0 || C <= 0 || C % kV || C > 32 * kMaxVpl * kV || max_blocks <= 0) return -1;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int cv = C / kV;
  int lanes = 1;
  while (lanes < 32 && lanes * kMaxVpl < cv) lanes *= 2;
  const int vpl = (cv + lanes - 1) / lanes;
#define MUSEV_LN(N) launch_ln<N>(x, y, w, b, w_bf16, rows, C, s_row, eps, lanes, max_blocks, st)
  if (vpl <= 1) {
    MUSEV_LN(1);
  } else if (vpl <= 2) {
    MUSEV_LN(2);
  } else if (vpl <= 3) {
    MUSEV_LN(3);
  } else if (vpl <= 4) {
    MUSEV_LN(4);
  } else if (vpl <= 5) {
    MUSEV_LN(5);
  } else if (vpl <= 6) {
    MUSEV_LN(6);
  } else {
    MUSEV_LN(8);
  }
#undef MUSEV_LN
  return (int)cudaGetLastError();
}

const char* musev_cuda_error_string(int err) {
  if (err == -1) return "unsupported shape or plan";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
