// Flash attention for Hopper (sm_90a), bf16 in/out, fp32 logits and accumulator.
//
// Replaces two Pallas TPU kernels of musev_tpu/ops/pallas/flash_attention.py:
//   * _unroll_kernel (K1): K/V resident in VMEM, KV looped inside one program;
//   * _carry_kernel  (K3): KV split into parts along a sequential grid axis with
//     (m, l, acc) carried in VMEM scratch, for KV extents beyond VMEM.
// The resident-versus-carry split exists only because of the TPU's 16 MB scoped
// VMEM. Here one block owns a tile of query rows and loops over every KV tile
// with the online-softmax state (m, l, acc) in registers, so any sk is one kernel.
//
// Bound. At the largest main-path site (576^2 ReferenceOnly cond half: bh 312,
// sq 5184, sk 10368, d 40) the work is 4*312*5184*10368*40 = 2.7 TFLOP against
// 0.3 GB of q/k/v/o: 2.7 ms at 989 TFLOP/s bf16 versus 0.1 ms at 3.35 TB/s, so
// the bound is the tensor cores. The design feeds them with mma.sync
// m16n8k16 (bf16 x bf16 -> fp32) on tiles staged in shared memory; S = Q K^T
// stays in registers and is re-packed in place as the A operand of P V (the
// accumulator layout of two n8 tiles is the A layout of one k16 step), so
// logits never touch shared or device memory. K and V are read once per
// query tile of 64 rows. wgmma/TMA pipelining is left for later work.
//
// Layout. q/k/v are addressed as (B, S, H, D) with arbitrary element strides
// for B, S and H (D contiguous), so the fused QKV projection's views go in
// without transposes or copies; o is written contiguous (B, Sq, H, D).
// Head dims are padded to a multiple of 16 inside shared memory only
// (d = 40 -> 48): the pad columns are zero-filled and never written back.
// Ragged sq and sk tails are masked in the kernel; a row whose keys are all
// masked yields 0 (the Pallas kernel's safe_l).
//
// Head dim 512 (the VAE mid-block) would need 256 fp32 accumulators per
// thread, so there four warps share each 16-row group and each owns a quarter
// of the output columns; each recomputes the group's S (QK^T flops x4, PV x1).
//
// Softmax stats (the with_stats=True outputs of _unroll_kernel, for the JAX
// package's split-merge route): when m/l are given, each row's running max m
// (of s * scale * log2e, the log2 units of the kernel's exp2) and
// l = sum exp2(s * scale * log2e - m) are written in fp32 to (B, Sq, H)
// arrays, so partial results over KV parts merge exactly. A row whose keys are
// all masked keeps m = -inf and l = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 from one column of consecutive rows, packed low = first row.
__device__ __forceinline__ uint32_t ld_col_pair(const __nv_bfloat16* p, int stride) {
  uint16_t lo = *reinterpret_cast<const uint16_t*>(p);
  uint16_t hi = *reinterpret_cast<const uint16_t*>(p + stride);
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy rows [row0, row0 + rows) of one (b, h) slice into shared memory as a
// (rows, DP) tile with row stride LDS, zero-filling rows >= n and cols >= d.
template <int DP, int LDS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                          long long s_stride, int row0, int rows, int n,
                                          int d, int tid, int nthreads) {
  constexpr int kVec = 8;  // 8 bf16 = 16 bytes per thread per step
  constexpr int kChunks = DP / kVec;
  for (int i = tid; i < rows * kChunks; i += nthreads) {
    int r = i / kChunks;
    int c = (i - r * kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    int gr = row0 + r;
    if (gr < n && c < d) {
      val = *reinterpret_cast<const uint4*>(base + (long long)gr * s_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
  }
}

template <int DP, int WQ, int WD, int BK>
__global__ void __launch_bounds__(WQ* WD * 32)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     int H, int Sq, int Sk, int D, long long q_sb, long long q_ss,
                     long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh, float scale_log2,
                     float* __restrict__ m_out, float* __restrict__ l_out) {
  constexpr int BQ = 16 * WQ;
  constexpr int NT = WQ * WD * 32;
  constexpr int LDS = DP + 8;      // row stride: conflict-free 32-bit fragment loads
  constexpr int DW = DP / WD;      // output columns owned by one warp
  constexpr int NO = DW / 8;       // output n8 tiles per warp
  constexpr int NS = BK / 8;       // logits n8 tiles per warp
  static_assert(DP % 16 == 0 && DW % 8 == 0 && BK % 16 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LDS;
  __nv_bfloat16* Vs = Ks + BK * LDS;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within an 8-row group
  const int t = lane & 3;   // column pair within a k16 step
  const int wq = warp / WD;
  const int wd = warp - wq * WD;
  const int r0 = wq * 16;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  load_tile<DP, LDS>(Qs, qb, q_ss, q0, BQ, Sq, D, tid, NT);

  float acc[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max, rows g and g + 8
  float l_lo = 0.f, l_hi = 0.f;              // this thread's partial row sums

  const __nv_bfloat16* qa = Qs + (r0 + g) * LDS + 2 * t;
  for (int kv0 = 0; kv0 < Sk; kv0 += BK) {
    __syncthreads();  // previous tile fully consumed
    load_tile<DP, LDS>(Ks, kb, k_ss, kv0, BK, Sk, D, tid, NT);
    load_tile<DP, LDS>(Vs, vb, v_ss, kv0, BK, Sk, D, tid, NT);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and BK keys.
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP; kk += 16) {
      uint32_t a[4];
      a[0] = ld_u32(qa + kk);
      a[1] = ld_u32(qa + 8 * LDS + kk);
      a[2] = ld_u32(qa + kk + 8);
      a[3] = ld_u32(qa + 8 * LDS + kk + 8);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const __nv_bfloat16* kp = Ks + (j * 8 + g) * LDS + kk + 2 * t;
        mma_bf16_16816(s[j], a, ld_u32(kp), ld_u32(kp + 8));
      }
    }

    // Scale into log2 units, mask the ragged KV tail, online softmax.
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      int col = kv0 + j * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int c = col + (e & 1);
        s[j][e] = c < Sk ? s[j][e] * scale_log2 : -INFINITY;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    float mn_lo = fmaxf(m_lo, mx_lo);
    float mn_hi = fmaxf(m_hi, mx_hi);
    // A row with no unmasked key so far keeps max -inf: subtract 0 instead,
    // so exp2(-inf) = 0 and no inf - inf NaN appears.
    float base_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
    float base_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    float alpha_lo = exp2f(m_lo - base_lo);
    float alpha_hi = exp2f(m_hi - base_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = exp2f(s[j][0] - base_lo);
      s[j][1] = exp2f(s[j][1] - base_lo);
      s[j][2] = exp2f(s[j][2] - base_hi);
      s[j][3] = exp2f(s[j][3] - base_hi);
      sum_lo += s[j][0] + s[j][1];
      sum_hi += s[j][2] + s[j][3];
    }
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      acc[i][0] *= alpha_lo;
      acc[i][1] *= alpha_lo;
      acc[i][2] *= alpha_hi;
      acc[i][3] *= alpha_hi;
    }

    // O += P V over this warp's output columns.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* vp = Vs + (kk * 16 + 2 * t) * LDS + wd * DW + g;
#pragma unroll
      for (int i = 0; i < NO; ++i) {
        uint32_t b0 = ld_col_pair(vp + i * 8, LDS);
        uint32_t b1 = ld_col_pair(vp + 8 * LDS + i * 8, LDS);
        mma_bf16_16816(acc[i], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;
  const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
  const int row_lo = q0 + r0 + g;
  const int row_hi = row_lo + 8;
  if (m_out != nullptr && t == 0 && wd == 0) {
    const long long st = (long long)b * Sq * H + h;
    if (row_lo < Sq) {
      m_out[st + (long long)row_lo * H] = m_lo;
      l_out[st + (long long)row_lo * H] = l_lo;
    }
    if (row_hi < Sq) {
      m_out[st + (long long)row_hi * H] = m_hi;
      l_out[st + (long long)row_hi * H] = l_hi;
    }
  }
  const long long o_ss = (long long)H * D;
  __nv_bfloat16* ob = o + (long long)b * Sq * o_ss + (long long)h * D;
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    int col = wd * DW + i * 8 + 2 * t;
    if (col < D) {
      if (row_lo < Sq)
        *reinterpret_cast<uint32_t*>(ob + row_lo * o_ss + col) =
            pack_bf16(acc[i][0] * inv_lo, acc[i][1] * inv_lo);
      if (row_hi < Sq)
        *reinterpret_cast<uint32_t*>(ob + row_hi * o_ss + col) =
            pack_bf16(acc[i][2] * inv_hi, acc[i][3] * inv_hi);
    }
  }
}

template <int DP, int WQ, int WD, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H,
                   int Sq, int Sk, int D, const long long* qs, const long long* ks,
                   const long long* vs, float scale, float* m, float* l,
                   cudaStream_t stream) {
  constexpr int BQ = 16 * WQ;
  constexpr int LDS = DP + 8;
  const size_t smem = (size_t)(BQ + 2 * BK) * LDS * sizeof(__nv_bfloat16);
  auto kernel = flash_fwd_kernel<DP, WQ, WD, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  kernel<<<grid, WQ * WD * 32, smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(v), reinterpret_cast<__nv_bfloat16*>(o), H, Sq,
      Sk, D, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
      scale * kLog2e, m, l);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q/k/v strides are (batch, seq, head) in elements; the head dim is contiguous.
// m and l are null, or fp32 (B, Sq, H) outputs for the softmax stats.
// Returns 0 on success, a cudaError_t, or -1 for an unsupported head dim.
int musev_flash_attention_bf16(const void* q, const void* k, const void* v, void* o, int B,
                               int H, int Sq, int Sk, int D, long long q_sb, long long q_ss,
                               long long q_sh, long long k_sb, long long k_ss,
                               long long k_sh, long long v_sb, long long v_ss,
                               long long v_sh, float scale, void* m, void* l, void* stream) {
  const long long qs[3] = {q_sb, q_ss, q_sh};
  const long long ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  float* mf = reinterpret_cast<float*>(m);
  float* lf = reinterpret_cast<float*>(l);
  if (D <= 0 || D % 8 != 0) return -1;
  if (D <= 48) return launch<48, 4, 1, 64>(q, k, v, o, B, H, Sq, Sk, D, qs, ks, vs, scale, mf, lf, st);
  if (D <= 64) return launch<64, 4, 1, 64>(q, k, v, o, B, H, Sq, Sk, D, qs, ks, vs, scale, mf, lf, st);
  if (D <= 80) return launch<80, 4, 1, 64>(q, k, v, o, B, H, Sq, Sk, D, qs, ks, vs, scale, mf, lf, st);
  if (D <= 160) return launch<160, 4, 1, 32>(q, k, v, o, B, H, Sq, Sk, D, qs, ks, vs, scale, mf, lf, st);
  if (D <= 512) return launch<512, 2, 4, 32>(q, k, v, o, B, H, Sq, Sk, D, qs, ks, vs, scale, mf, lf, st);
  return -1;
}

const char* musev_cuda_error_string(int err) {
  if (err == -1) return "unsupported head dim";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
