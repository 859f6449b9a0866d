// Multi-head self-attention over short packed rows, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _kernel behind short_attention_packed
// (musev_tpu/ops/pallas/short_attention.py:39), which runs attn1 and attn2 of
// every temporal transformer: rows of T <= 64 frames per pixel, q/k/v packed
// (N, T, C) straight from the fused QKV projection, C = n_heads * D, row
// stride ld (3C for the fused views). Keys at positions >= kv_len are masked;
// outputs of those query rows are computed over the valid keys and left to
// the caller.
//
// Bound. Each q/k/v element is read once and each output written once:
// 4 * N * T * C * 2 bytes, about 1.0 GB at the 576^2 top level (N = 31,104,
// T = 13, C = 320), 0.31 ms at 3.35 TB/s. The 2 * T * T * C multiply-adds per
// pixel row (3.4 G at that site) are far below the tensor cores' line, so the
// bound is bytes, and the design is about moving them at the memory's rate:
//   * A work unit is one pixel row n and a group of HG heads (all 8 heads at
//     the paths' sites up to C = 640; HG is chosen by the host so a unit
//     stays near 32 KB of shared memory). For each frame t its q, k and v
//     columns are runs of HG * D * 2 bytes (the fused projection puts them
//     side by side: the whole unit is one contiguous block of memory), staged
//     with 16-byte cp.async into shared rows [q | k | v | pad].
//   * Persistent blocks of four warps, several per SM, walk the units with a
//     two-stage ring: unit i + 1 is in flight while unit i computes and
//     stores, so each SM keeps several units' loads outstanding.
//   * The arithmetic runs on the tensor cores (mma.sync m16n8k16, bf16 in,
//     fp32 out) with T padded to TP (16, 32 or 64): a warp takes one head and
//     one tile of 16 query frames, S = Q K^T over D (padded to 16; the
//     columns past D are zeroed in the fragments), the softmax over all TP
//     keys whole in fp32 registers (one row max and one row sum per query
//     row, two shuffles each; no online rescaling), then O = P V. Fragments
//     come from shared memory by ldmatrix; the row stride is an odd number of
//     16-byte chunks, so the eight rows of an 8x8 matrix hit eight different
//     bank groups.
//   * The output is written back over the unit's q columns in shared memory
//     and leaves as 16-byte stores, each frame's HG * D columns one run of the
//     contiguous (N, T, C) output.
// Padding rows (frames T..TP-1) are zero in shared memory (cp.async never
// writes them), so P = 0 meets V = 0 there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;
constexpr int kUnitTarget = 32 * 1024;  // shared bytes a unit aims at (one stage)
constexpr int kMaxStageBytes = 112 * 1024;  // two stages fit the 227 KB of a block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shape of one launch, fixed on the host. A unit's shared rows are RS
// elements wide: q at column 0, k at W, v at 2 W (W = HG * D), then padding.
struct Plan {
  int T, D, HG, W, RS, units_per_row, kv_len;
  long long N, ld, C;
  float scale_log2;
};

// TP: frames padded to 16, 32 or 64; DP: the head dim's upper bound for the
// instance (a multiple of 16; D itself is a multiple of 8 up to DP).
template <int TP, int DP>
__global__ void __launch_bounds__(kThreads)
    short_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      Plan p) {
  constexpr int NS = TP / 8;   // logit n8 tiles per query row tile
  constexpr int NO = DP / 8;   // output n8 tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stage_base = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int stage_elems = TP * p.RS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int chunks_w = p.W / 8;  // 16-byte chunks of one frame's q (or k, v) run
  const long long units = p.N * p.units_per_row;

  // Zero both stages once: padding rows and columns stay zero.
  {
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    const int n16 = kStages * stage_elems / 8;
    for (int i = tid; i < n16; i += kThreads) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  auto issue = [&](long long unit, int stage) {
    const long long n = unit / p.units_per_row;
    const int h0 = (int)(unit - n * p.units_per_row) * p.HG;
    __nv_bfloat16* st = stage_base + stage * stage_elems;
    const long long col0 = (long long)h0 * p.D;
    const int per_t = 3 * chunks_w;
    for (int i = tid; i < p.T * per_t; i += kThreads) {
      const int t = i / per_t;
      const int r = i - t * per_t;
      const int which = r / chunks_w;  // 0 q, 1 k, 2 v
      const int c = (r - which * chunks_w) * 8;
      const __nv_bfloat16* src = which == 0 ? q : which == 1 ? k : v;
      cp_async16(st + t * p.RS + which * p.W + c, src + (n * p.T + t) * p.ld + col0 + c);
    }
  };

  const int q_tiles = TP / 16;
  const int items = p.HG * q_tiles;
  long long unit = blockIdx.x;
  for (int s = 0; s < kStages - 1; ++s) {
    if (unit + (long long)s * gridDim.x < units) issue(unit + (long long)s * gridDim.x, s);
    cp_async_commit();
  }
  for (int i = 0; unit < units; unit += gridDim.x, ++i) {
    // the unit kStages - 1 laps ahead goes into the stage freed last lap
    const long long ahead = unit + (long long)(kStages - 1) * gridDim.x;
    if (ahead < units) issue(ahead, (i + kStages - 1) % kStages);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait<kStages - 1>();  // this unit's group has landed
    __syncthreads();
    __nv_bfloat16* st = stage_base + (i % kStages) * stage_elems;

    for (int item = warp; item < items; item += kWarps) {
      const int hl = item / q_tiles;
      const int row0 = (item - hl * q_tiles) * 16;
      const __nv_bfloat16* Qs = st + hl * p.D;
      const __nv_bfloat16* Ks = st + p.W + hl * p.D;
      const __nv_bfloat16* Vs = st + 2 * p.W + hl * p.D;

      // S = Q K^T: 16 query rows x TP keys over D (k-steps of 16 columns).
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        if (16 * kk < p.D) {
          const bool half = 16 * kk + 8 >= p.D;  // columns 8..15 lie past D
          uint32_t a[4];
          ldmatrix_x4(a, Qs + (row0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * p.RS + 16 * kk +
                             8 * (lane >> 4));
          if (half) a[2] = a[3] = 0u;
#pragma unroll
          for (int j = 0; j < TP / 16; ++j) {
            uint32_t b[4];
            ldmatrix_x4(b, Ks + (16 * j + (lane & 7) + 8 * (lane >> 4)) * p.RS + 16 * kk +
                               8 * ((lane >> 3) & 1));
            if (half) b[1] = b[3] = 0u;
            mma_bf16_16816(s[2 * j], a, b[0], b[1]);
            mma_bf16_16816(s[2 * j + 1], a, b[2], b[3]);
          }
        }
      }

      // Softmax over the TP keys, whole: keys >= kv_len (padding included)
      // get p = 0; kv_len >= 1, so each row's max is finite.
      float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * j + 2 * t4 + (e & 1);
          s[j][e] = key < p.kv_len ? s[j][e] * p.scale_log2 : -INFINITY;
        }
        mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
        mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][0] = ex2(s[j][0] - mx_lo);
        s[j][1] = ex2(s[j][1] - mx_lo);
        s[j][2] = ex2(s[j][2] - mx_hi);
        s[j][3] = ex2(s[j][3] - mx_hi);
        sum_lo += s[j][0] + s[j][1];
        sum_hi += s[j][2] + s[j][3];
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, off);
        sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, off);
      }

      // O = P V over the head's columns, two n8 tiles per ldmatrix.
      float acc[NO][4];
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < TP / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int i = 0; i < NO / 2; ++i) {
          if (16 * i < p.D) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, Vs + (16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * p.RS +
                                     16 * i + 8 * (lane >> 4));
            mma_bf16_16816(acc[2 * i], a, b[0], b[1]);
            mma_bf16_16816(acc[2 * i + 1], a, b[2], b[3]);
          }
        }
      }

      // Normalised output over this head's q columns (rows < T only; the
      // tile past D, where D % 16 == 8, is dropped).
      const float inv_lo = 1.f / sum_lo;
      const float inv_hi = 1.f / sum_hi;
      __nv_bfloat16* Os = st + hl * p.D;
      const int r_lo = row0 + g, r_hi = r_lo + 8;
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        if (8 * i < p.D) {
          const int col = 8 * i + 2 * t4;
          if (r_lo < p.T)
            *reinterpret_cast<uint32_t*>(Os + r_lo * p.RS + col) =
                pack_bf16(acc[i][0] * inv_lo, acc[i][1] * inv_lo);
          if (r_hi < p.T)
            *reinterpret_cast<uint32_t*>(Os + r_hi * p.RS + col) =
                pack_bf16(acc[i][2] * inv_hi, acc[i][3] * inv_hi);
        }
      }
    }
    __syncthreads();

    // 16-byte stores: frame t's W output columns are one run of o.
    {
      const long long n = unit / p.units_per_row;
      const int h0 = (int)(unit - n * p.units_per_row) * p.HG;
      for (int i = tid; i < p.T * chunks_w; i += kThreads) {
        const int t = i / chunks_w;
        const int c = (i - t * chunks_w) * 8;
        *reinterpret_cast<uint4*>(o + (n * p.T + t) * p.C + (long long)h0 * p.D + c) =
            *reinterpret_cast<const uint4*>(st + t * p.RS + c);
      }
    }
    __syncthreads();  // the stage is refilled next lap
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <int TP, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const Plan& p,
                   int smem, cudaStream_t stream) {
  auto kernel = short_attn_kernel<TP, DP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long units = p.N * p.units_per_row;
  const long long cap = (long long)sms * per_sm;
  const int blocks = (int)(units < cap ? units : cap);
  kernel<<<blocks, kThreads, smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(v), reinterpret_cast<__nv_bfloat16*>(o), p);
  return cudaGetLastError();
}

template <int TP>
cudaError_t launch_tp(const void* q, const void* k, const void* v, void* o, const Plan& p,
                      int smem, cudaStream_t stream) {
  if (p.D <= 48) return launch<TP, 48>(q, k, v, o, p, smem, stream);
  if (p.D <= 96) return launch<TP, 96>(q, k, v, o, p, smem, stream);
  // at TP = 64 a 160-wide instance made ptxas spill; the 256-wide one covers it
  if (p.D <= 160 && TP < 64) return launch<TP, 160>(q, k, v, o, p, smem, stream);
  return launch<TP, 256>(q, k, v, o, p, smem, stream);
}

}  // namespace

extern "C" {

// q/k/v: (N, T, n_heads * D) bf16 with row stride ``ld`` elements and unit
// column stride, 16-byte aligned, ld and D multiples of 8; o: contiguous
// (N, T, n_heads * D). Returns 0, a cudaError_t, or -1 for an unsupported
// shape.
int musev_short_attention_bf16(const void* q, const void* k, const void* v, void* o,
                               long long N, int n_heads, int T, int D, long long ld,
                               int kv_len, float scale, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 8 != 0 || D > 256 || ld % 8 != 0 || T < 1 || T > 64) return -1;
  if (kv_len < 1 || kv_len > T || n_heads < 1 || N < 1) return -1;
  const int TP = T <= 16 ? 16 : T <= 32 ? 32 : 64;
  // Heads per unit: the largest divisor of n_heads whose unit fits the
  // target; a row stride of an odd number of 16-byte chunks.
  Plan p{};
  p.T = T;
  p.D = D;
  p.N = N;
  p.ld = ld;
  p.C = (long long)n_heads * D;
  p.kv_len = kv_len;
  p.scale_log2 = scale * kLog2e;
  int bytes = 0;
  for (int hg = n_heads; hg >= 1; --hg) {
    if (n_heads % hg) continue;
    const int w = hg * D;
    const int chunks = 3 * w / 8;
    const int rs = 8 * (chunks + (chunks % 2 == 0 ? 1 : 2));
    bytes = TP * rs * 2;
    p.HG = hg, p.W = w, p.RS = rs;
    if (bytes <= kUnitTarget) break;
  }
  if (bytes > kMaxStageBytes) return -1;
  p.units_per_row = n_heads / p.HG;
  const int smem = kStages * bytes;
  if (TP == 16) return launch_tp<16>(q, k, v, o, p, smem, st);
  if (TP == 32) return launch_tp<32>(q, k, v, o, p, smem, st);
  return launch_tp<64>(q, k, v, o, p, smem, st);
}

const char* musev_cuda_error_string(int err) {
  if (err == -1) return "unsupported shape";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
