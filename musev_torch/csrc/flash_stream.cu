// Long-KV flash attention for Hopper (sm_90a): K/V streamed through a
// two-stage cp.async pipeline in shared memory past a 128-row query chunk.
// bf16 in/out, fp32 logits, softmax state and accumulator.
//
// Replaces the Pallas TPU kernel _stream_kernel
// (musev_tpu/ops/pallas/flash_attention.py:165, driven by _flash_stream
// :255-294). Its idea is kept: one program owns a large resident q chunk and
// streams the KV extent past it exactly once, copies double-buffered against
// compute, with every q sub-block's online-softmax state (m, l, acc) carried in
// registers. Here one block owns 128 query rows over 8 warps (16 rows each);
// each K/V tile of BK rows is copied once into shared memory for all 8 warps
// with cp.async, and the copy of tile j + 1 is in flight while the warps run
// tile j's mma (cp.async.wait_group 1). K and V are read once per 128 query
// rows, half as often as by the flash kernel's 64-row blocks. The TPU devices
// of _flash_stream are dropped: the d -> 128 lane padding (:259-262) and the
// (bh, n_sub, sub_kv, 128) reshape for DMA slicing (:268-269). K/V are read
// through the (B, S, H, D) strides of the caller's views, and d = 40 is padded
// to 48 in shared memory only (cp.async zero-fills the pad columns).
//
// Bound. At the L0 ReferenceNet fuse site of the musev_referencenet preset
// (B 78, H 8, sq 5184, sk 10368, d 40) the work is
// 4 * 78 * 8 * 5184 * 10368 * 40 = 5.37 TFLOP against 0.33 GB of q/k/v/o:
// 5.4 ms at 989 TFLOP/s bf16 versus 0.1 ms at 3.35 TB/s, so the tensor cores
// bound it. The design feeds them from shared memory with ldmatrix (K as the
// col-major B operand of S = Q K^T, V transposed as the B operand of P V) and
// mma.sync m16n8k16; Q's fragments are loaded once and stay in registers for
// the whole stream; S stays in registers and is re-packed as the A operand of
// P V, so logits never touch shared or device memory. wgmma/TMA and warp
// specialisation are left for later work.
//
// Ragged sq and sk tails are masked; a row whose keys are all masked yields 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWarps = 8;
constexpr int kBQ = 16 * kWarps;  // query rows per block
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 address the rows of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Start the copy of rows [row0, row0 + ROWS) of one (b, h) slice into a
// (ROWS, DP) shared tile with row stride LDS; rows >= n and cols >= d are zeros.
template <int DP, int LDS, int ROWS>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                           long long s_stride, int row0, int n, int d,
                                           int tid) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks per row
  for (int i = tid; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * 8;
    const int gr = row0 + r;
    const bool valid = gr < n && c < d;
    const __nv_bfloat16* src = valid ? base + (long long)gr * s_stride + c : base;
    cp_async16(dst + r * LDS + c, src, valid);
  }
}

template <int DP, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_stream_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                        int H, int Sq, int Sk, int D, long long q_sb, long long q_ss,
                        long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                        long long v_sb, long long v_ss, long long v_sh, float scale_log2) {
  constexpr int LDS = DP + 8;  // row stride: conflict-free ldmatrix rows
  constexpr int KD = DP / 16;  // k16 steps over the head dim
  constexpr int NO = DP / 8;   // output n8 tiles per warp
  constexpr int NS = BK / 8;   // logits n8 tiles per warp
  static_assert(DP % 16 == 0 && BK % 16 == 0 && NO % 2 == 0 && NS % 2 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBQ * LDS;     // two stages of (BK, LDS)
  __nv_bfloat16* Vs = Ks + 2 * BK * LDS;  // two stages of (BK, LDS)

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // row within an 8-row group
  const int t = lane & 3;   // column pair within a k16 step
  const int lm = lane >> 3; // the 8x8 matrix whose row this lane addresses
  const int lr = lane & 7;  // that row
  const int r0 = warp * 16;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  const int n_tiles = (Sk + BK - 1) / BK;
  stage_tile<DP, LDS, kBQ>(Qs, qb, q_ss, q0, Sq, D, tid);
  stage_tile<DP, LDS, BK>(Ks, kb, k_ss, 0, Sk, D, tid);
  stage_tile<DP, LDS, BK>(Vs, vb, v_ss, 0, Sk, D, tid);
  cp_async_commit();

  uint32_t qf[KD][4];
  float acc[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY;  // running max, rows g and g + 8
  float l_lo = 0.f, l_hi = 0.f;              // this thread's partial row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {  // the next tile's copy overlaps this tile's math
      stage_tile<DP, LDS, BK>(Ks + (stage ^ 1) * BK * LDS, kb, k_ss, (it + 1) * BK, Sk, D, tid);
      stage_tile<DP, LDS, BK>(Vs + (stage ^ 1) * BK * LDS, vb, v_ss, (it + 1) * BK, Sk, D, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the copy just started has landed
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qf[kk], Qs + (r0 + (lm & 1) * 8 + lr) * LDS + kk * 16 + (lm >> 1) * 8);
    }
    const __nv_bfloat16* Kt = Ks + stage * BK * LDS;
    const __nv_bfloat16* Vt = Vs + stage * BK * LDS;
    const int kv0 = it * BK;

    // S = Q K^T for this warp's 16 rows and BK keys.
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t bk[4];  // b0, b1 of key tiles j and j + 1
        ldsm_x4(bk, Kt + ((j + (lm >> 1)) * 8 + lr) * LDS + kk * 16 + (lm & 1) * 8);
        mma_bf16_16816(s[j], qf[kk], bk[0], bk[1]);
        mma_bf16_16816(s[j + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // Scale into log2 units, mask the ragged KV tail, online softmax.
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int col = kv0 + j * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = col + (e & 1) < Sk ? s[j][e] * scale_log2 : -INFINITY;
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo);
    const float mn_hi = fmaxf(m_hi, mx_hi);
    // A row with no unmasked key so far keeps max -inf: subtract 0 instead,
    // so exp2(-inf) = 0 and no inf - inf NaN appears.
    const float base_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
    const float base_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    const float alpha_lo = exp2f(m_lo - base_lo);
    const float alpha_hi = exp2f(m_hi - base_hi);
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

    // O += P V: P is re-packed from S's accumulators as the A operand.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int i = 0; i < NO; i += 2) {
        uint32_t bv[4];  // b0, b1 of output tiles i and i + 1
        ldsm_x4_trans(bv, Vt + (kk * 16 + (lm & 1) * 8 + lr) * LDS + i * 8 + (lm >> 1) * 8);
        mma_bf16_16816(acc[i], a, bv[0], bv[1]);
        mma_bf16_16816(acc[i + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage is refilled by the next iteration's copy
  }
  cp_async_wait<0>();  // no copy outlives the block (sk = 0 leaves the first)

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float inv_lo = l_lo > 0.f ? 1.f / l_lo : 0.f;
  const float inv_hi = l_hi > 0.f ? 1.f / l_hi : 0.f;
  const int row_lo = q0 + r0 + g;
  const int row_hi = row_lo + 8;
  const long long o_ss = (long long)H * D;
  __nv_bfloat16* ob = o + (long long)b * Sq * o_ss + (long long)h * D;
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    const int col = i * 8 + 2 * t;
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

template <int DP, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
                   int Sk, int D, const long long* qs, const long long* ks, const long long* vs,
                   float scale, cudaStream_t stream) {
  constexpr int LDS = DP + 8;
  const size_t smem = (size_t)(kBQ + 4 * BK) * LDS * sizeof(__nv_bfloat16);
  auto kernel = flash_stream_kernel<DP, BK>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(v), reinterpret_cast<__nv_bfloat16*>(o), H, Sq,
      Sk, D, qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q/k/v strides are (batch, seq, head) in elements; the head dim is contiguous.
// Returns 0 on success, a cudaError_t, or -1 for an unsupported head dim.
int musev_flash_stream_bf16(const void* q, const void* k, const void* v, void* o, int B, int H,
                            int Sq, int Sk, int D, long long q_sb, long long q_ss,
                            long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh, float scale,
                            void* stream) {
  const long long qs[3] = {q_sb, q_ss, q_sh};
  const long long ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (D <= 0 || D % 8 != 0) return -1;
  if (D <= 48) return launch<48, 64>(q, k, v, o, B, H, Sq, Sk, D, qs, ks, vs, scale, st);
  if (D <= 80) return launch<80, 64>(q, k, v, o, B, H, Sq, Sk, D, qs, ks, vs, scale, st);
  if (D <= 160) return launch<160, 32>(q, k, v, o, B, H, Sq, Sk, D, qs, ks, vs, scale, st);
  return -1;
}

const char* musev_cuda_error_string(int err) {
  if (err == -1) return "unsupported head dim";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
