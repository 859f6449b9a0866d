// Flash attention for Hopper (sm_90a), bf16 in/out, fp32 logits and accumulator.
//
// Replaces three Pallas TPU kernels of musev_tpu/ops/pallas/flash_attention.py:
//   * _unroll_kernel (K1): K/V resident in VMEM, KV looped inside one program;
//   * _carry_kernel  (K3): KV split into parts along a sequential grid axis with
//     (m, l, acc) carried in VMEM scratch, for KV extents beyond VMEM;
//   * _unroll_kernel with_stats=True (K1s): the same plus each row's softmax
//     stats (m, l), merged across KV parts by the split-merge route.
// The resident-versus-carry split exists only because of the TPU's 16 MB scoped
// VMEM. Here a block takes a tile of query rows of one (b, h) and loops over
// every KV tile with the online-softmax state in registers, so any sk is one
// launch.
//
// Bound. Per logit the kernel does 4 * dp tensor-core flops (dp: the head dim
// padded to 16) and one exp2. At 989 TFLOP/s bf16 and about 3.9 T exp2/s
// (16 MUFU.EX2 per clock per SM, 132 SMs, ~1.83 GHz) the two meet at
// 4 * d = 989 / 3.9, d ~ 63: below that the exponential unit binds, above it
// the tensor cores. At the 576^2 L0 sites (d = 40, dp = 48) the exp2 floor is
// 2.15 ms for the self-attention site (bh 312, 5184^2 logits) against 1.36 ms
// of tensor-core time at d = 40; at d = 80 and 160 the tensor cores bind.
// A third limit is the K/V traffic from L2 into shared memory: each K/V tile
// is read once per block, so the bytes per logit fall as a block holds more
// query rows.
//
// Design for head dims up to 160 (flash_fwd_wgmma_kernel; its per-instance
// plans are Config in flash_common.cuh):
//   * Warp specialisation. Warpgroup 0 is the producer: it gives up
//     registers (setmaxnreg 24) and one thread issues TMA loads, each work
//     item's Q into one of NQ buffers and K and V tiles into a ring of NS
//     stages, each completing on its own mbarrier (full); consumers free a
//     buffer on a second mbarrier (empty).
//   * NC consumer warpgroups, 64 query rows each (setmaxnreg 160 with three,
//     240 with two). d <= 40 takes three (192 rows per block, so each K/V
//     tile serves 1.5x the rows of a 128-row block), larger d two.
//   * S = Q K^T is wgmma m64nBKk16 with Q and K from shared memory; P V is
//     wgmma m64nDNk16 with P from registers (the S accumulator re-packed to
//     bf16: its layout is the A-fragment layout) and V from shared memory as
//     an MN-major operand. DN is d padded to 8 only (40 at d = 40). Logits
//     never leave registers.
//   * Overlap within a warpgroup: the next tile's Q K^T and the previous
//     tile's P V are issued back to back; the softmax (exp2) of the new tile
//     runs while P V is still on the tensor cores. Across the consumers:
//     named barriers give them turns to issue (ping-pong), so one's exp2 runs
//     while the others' products run. This is what the exp2 floor at
//     d <= 64 asks for.
//   * Softmax: the row max is taken over raw logits and p = exp2(s * c - m)
//     is one FFMA and one MUFU.EX2 (c = scale * log2 e); the key mask runs on
//     the last, ragged tile only. (Skipping the exp2 of n8 blocks past sk, or
//     the P V k-steps past sk, puts branches among the wgmma and ptxas then
//     serialises every wgmma: C7511, C7520.)
//   * Persistent blocks: one per SM, each walking work items (a (b, h) and a
//     query tile; the tiles of one (b, h) adjacent, so blocks on the card at
//     one time share K/V in L2). The next items' Q and K/V load while this
//     item's epilogue runs, which is most of the cost at short KV (the 4 IP
//     tokens, the 77 text tokens).
// Shared-memory layout: every tile is stored as slabs of SW-byte rows (SW / 2
// columns) with the SW-byte swizzle (TMA SWIZZLE_32B/64B/128B, wgmma layout
// B32/B64/B128): K-major for Q and K (SBO 8 * SW bytes between 8-row groups;
// a 16-column k-step starts 32 bytes further into the slab's rows), MN-major
// for V (LBO one slab between column groups, SBO 8 * SW bytes between 8-key
// groups). d = 40 uses 64-byte rows (32-column slabs), and Q K^T runs 3
// k-steps over 48 of the 64 columns (a depth of 64 would cost a third more
// work). TMA zero-fills the columns past d and the rows past sq or sk.
//
// Layout. q/k/v are addressed as (B, S, H, D) with arbitrary element strides
// for B, S and H (D contiguous), so the fused QKV projection's views go in
// without transposes or copies: each is described by a 4-D TMA tensor map over
// (D, S, H, B), encoded on the host per call through the driver entry point
// cuTensorMapEncodeTiled (no -lcuda) and passed as a __grid_constant__. TMA
// needs a 16-byte aligned base and strides that are multiples of 16 bytes; a
// dim of extent 1 is never stepped and gets a legal stride. o is written
// contiguous (B, Sq, H, D) from registers. A row whose keys are all masked
// (sk = 0) yields 0 (the Pallas kernel's safe_l).
//
// Head dims from 161 to 512 (the VAE mid-block, d = 512, 2-4 launches per
// clip) take flash_fwd_wide_kernel, the same machinery (TMA maps, mbarrier
// K/V buffers, wgmma, setmaxnreg) with two consumer warpgroups sharing 64
// query rows: each computes half of Q K^T's depth, the halves are summed
// through shared memory, and each owns half of the 512 output columns (see
// its note). Dispatch is by head dim and fixed. Every instance reads q/k/v
// through TMA, so no head dim takes a stride-0 broadcast.
//
// Softmax stats (K1s): when m/l are given, each row's running max m (of
// s * scale * log2 e) and l = sum exp2(s * scale * log2 e - m) are written in
// fp32 to (B, Sq, H) arrays, so partial results over KV parts merge exactly.
// A row whose keys are all masked keeps m = -inf and l = 0.

#include "flash_common.cuh"

namespace {

// ---- Warp-specialised wgmma/TMA kernel, head dims up to 160 -----------------

template <class C>
__global__ void __launch_bounds__(C::kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           __nv_bfloat16* __restrict__ o, int H, int Sq, int Sk, int D,
                           int q_tiles, int items, float scale_log2, float* __restrict__ m_out,
                           float* __restrict__ l_out) {
  constexpr int DP = C::DP, DN = C::DN, BK = C::BK, NS = C::NS, NQ = C::NQ, SW = C::SW;
  constexpr int NC = C::NC;
  constexpr int kSlabs = C::kSlabs;
  constexpr int kSlabCols = C::kSlabCols;
  constexpr int NSR = BK / 2;     // S accumulator floats per thread (m64 x BK)
  constexpr int NOR = DN / 2;     // O accumulator floats per thread (m64 x DN)
  constexpr int NP = BK / 4;      // P fragment registers per thread (BK / 16 k-steps x 4)
  constexpr int kTurn = 128 * 2;  // threads at a turn barrier: the syncing and the arriving group

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* empty_q = full_q + NQ;
  uint64_t* full_k = empty_q + NQ;
  uint64_t* full_v = full_k + NS;
  uint64_t* empty_k = full_v + NS;
  uint64_t* empty_v = empty_k + NS;

  const int nt = (Sk + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < NQ; ++i) {
      mbar_init(&full_q[i], 1);
      mbar_init(&empty_q[i], 128 * NC);
    }
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 128 * NC);
      mbar_init(&empty_v[s], 128 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Persistent: block x takes work items x, x + gridDim.x, ... An item is one
  // (b, h) and one tile of 64 * NC query rows; the q tiles of one (b, h) are
  // adjacent, so the blocks on the card at one time share K/V tiles in L2.
  // K/V tiles run through the ring in one sequence across items (tile
  // counter `kv`), and the Q buffers in turn by item (counter `it`).
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int kv = 0;
      for (int item = blockIdx.x, it = 0; item < items; item += gridDim.x, ++it) {
        const int bh = item / q_tiles;
        const int q0 = (item - bh * q_tiles) * C::kBlockQ;
        const int b = bh / H;
        const int h = bh - b * H;
        const int qb = it % NQ;
        unsigned char* qd = smem + qb * C::kQBytes;
        mbar_wait(&empty_q[qb], ((it / NQ) & 1) ^ 1);  // the first use passes at once
        mbar_expect_tx(&full_q[qb], C::kQBytes);
        for (int s = 0; s < kSlabs; ++s)
          tma_load(qd + s * C::kQSlab, &tm_q, &full_q[qb], kSlabCols * s, q0, h, b);
        for (int j = 0; j < nt; ++j, ++kv) {
          const int st = kv % NS;
          const uint32_t ph = (kv / NS) & 1;
          unsigned char* kd = smem + C::kKOff + st * C::kKVBytes;
          unsigned char* vd = smem + C::kVOff + st * C::kKVBytes;
          mbar_wait(&empty_k[st], ph ^ 1);
          mbar_expect_tx(&full_k[st], C::kKVBytes);
          for (int s = 0; s < kSlabs; ++s)
            tma_load(kd + s * C::kKVSlab, &tm_k, &full_k[st], kSlabCols * s, j * BK, h, b);
          mbar_wait(&empty_v[st], ph ^ 1);
          mbar_expect_tx(&full_v[st], C::kKVBytes);
          for (int s = 0; s < kSlabs; ++s)
            tma_load(vd + s * C::kKVSlab, &tm_v, &full_v[st], kSlabCols * s, j * BK, h, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs) : "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int g = (tid & 31) >> 2;  // row within an 8-row group
    const int t = tid & 3;          // column pair within an n8 block
    // Turns: consumer c issues its products after bar.sync on barrier 1 + c
    // and then lets consumer c + 1 (mod NC) go, so the consumers' products
    // queue on the tensor cores in a fixed order and each one's softmax runs
    // beside the others' products.
    const int my_turn = 1 + c;
    const int next_turn = 1 + (c + 1) % NC;
    const uint32_t k_base = smem_addr(smem + C::kKOff);
    const uint32_t v_base = smem_addr(smem + C::kVOff);

    float s_acc[NSR];
    float o_acc[NOR];
    uint32_t p_frag[NP];
    float m_lo, m_hi;          // running max (log2 units), rows g and g + 8
    float l_lo, l_hi;          // this thread's partial row sums
    float alpha_lo, alpha_hi;  // rescale of O owed by the last softmax
    uint32_t q_base = 0;
    int kv0 = 0;  // ring position of this item's first K/V tile

    // S = Q K^T of tile j: DP / 16 k-steps of 16 columns; a step starts
    // 32 bytes further into its slab's rows (the swizzle is a function of
    // the address, so the hardware finds each chunk), and 8-row groups are
    // 8 * SW bytes apart.
    auto issue_qk = [&](int j) {
      const uint32_t kt = k_base + ((kv0 + j) % NS) * C::kKVBytes;
      pin<NSR>(s_acc);
      wg_fence();
#pragma unroll
      for (int s = 0; s < DP / 16; ++s) {
        const uint32_t slab = 16 * s / kSlabCols, col_bytes = 16 * s % kSlabCols * 2;
        wgmma_ss<BK>(s_acc, smem_desc<SW>(q_base + slab * C::kQSlab + col_bytes, 16, 8 * SW),
                     smem_desc<SW>(kt + slab * C::kKVSlab + col_bytes, 16, 8 * SW), s > 0);
      }
      wg_commit();
      pin<NSR>(s_acc);
    };
    // O += P V of tile j: BK / 16 k-steps of 16 keys (all of them: a wgmma
    // under a runtime condition makes ptxas serialize every wgmma); V's slabs
    // are the MN-major operand's repeats along d (LBO), its 8-key groups
    // 8 * SW bytes apart (SBO).
    auto issue_pv = [&](int j) {
      const uint32_t vt = v_base + ((kv0 + j) % NS) * C::kKVBytes;
      pin<NOR>(o_acc);
      pin<NP>(p_frag);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<DN>(o_acc, p_frag + 4 * kk, smem_desc<SW>(vt + kk * 16 * SW, C::kKVSlab, 8 * SW));
      wg_commit();
      pin<NOR>(o_acc);
    };
    auto rescale_o = [&]() { rescale<NOR>(o_acc, alpha_lo, alpha_hi); };
    auto softmax = [&](int j) {
      softmax_tile<NSR, BK>(s_acc, scale_log2, j, Sk, t, m_lo, m_hi, l_lo, l_hi, alpha_lo,
                            alpha_hi);
    };
    auto pack = [&]() { pack_p<BK>(p_frag, s_acc); };
    auto wait_k = [&](int j) {
      mbar_wait(&full_k[(kv0 + j) % NS], ((kv0 + j) / NS) & 1);
    };
    auto wait_v = [&](int j) {
      mbar_wait(&full_v[(kv0 + j) % NS], ((kv0 + j) / NS) & 1);
    };

    for (int item = blockIdx.x, it = 0; item < items; item += gridDim.x, ++it, kv0 += nt) {
      const int bh = item / q_tiles;
      const int q0 = (item - bh * q_tiles) * C::kBlockQ;
      const int b = bh / H;
      const int h = bh - b * H;
      const int qb = it % NQ;
      q_base = smem_addr(smem + qb * C::kQBytes) + c * 64 * SW;
#pragma unroll
      for (int i = 0; i < NOR; ++i) o_acc[i] = 0.f;
      m_lo = m_hi = -INFINITY;
      l_lo = l_hi = 0.f;
      alpha_lo = alpha_hi = 1.f;

      mbar_wait(&full_q[qb], (it / NQ) & 1);
      if (nt > 0) {
        // the last consumer lets the first go; it takes no turn after its
        // last products, so every turn barrier completes within the item
        if (c == NC - 1) bar_arrive(1, kTurn);
        wait_k(0);
        bar_sync(my_turn, kTurn);
        issue_qk(0);
        bar_arrive(next_turn, kTurn);
        wg_wait<0>();
        pin<NSR>(s_acc);
        mbar_arrive(&empty_k[kv0 % NS]);
        if (nt == 1) mbar_arrive(&empty_q[qb]);
        softmax(0);
        pack();
        for (int j = 1; j < nt; ++j) {
          wait_k(j);
          bar_sync(my_turn, kTurn);
          issue_qk(j);
          rescale_o();
          wait_v(j - 1);
          issue_pv(j - 1);
          bar_arrive(next_turn, kTurn);
          wg_wait<1>();  // Q K^T of tile j done; P V of tile j - 1 may run on
          pin<NSR>(s_acc);
          mbar_arrive(&empty_k[(kv0 + j) % NS]);
          if (j == nt - 1) mbar_arrive(&empty_q[qb]);  // Q's last use
          softmax(j);
          wg_wait<0>();
          pin<NOR>(o_acc);
          pin<NP>(p_frag);
          mbar_arrive(&empty_v[(kv0 + j - 1) % NS]);
          pack();
        }
        rescale_o();
        wait_v(nt - 1);
        bar_sync(my_turn, kTurn);
        issue_pv(nt - 1);
        if (c != NC - 1) bar_arrive(next_turn, kTurn);
        wg_wait<0>();
        pin<NOR>(o_acc);
        mbar_arrive(&empty_v[(kv0 + nt - 1) % NS]);
      } else {
        mbar_arrive(&empty_q[qb]);
      }

      write_rows<DN / 8>(o_acc, m_lo, m_hi, l_lo, l_hi, q0 + 64 * c + 16 * warp + g, t, b, h, H,
                         Sq, D, 0, m_out != nullptr, o, m_out, l_out);
    }
  }
}

template <class C>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
                 int Sk, int D, const long long* qs, const long long* ks, const long long* vs,
                 float scale, float* m, float* l, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  // with no keys the K/V maps are never read (k and v may be null): describe q
  if (Sk == 0) k = v = q, ks = vs = qs;
  int err = tensor_map<C::SW>(&tq, q, B, Sq, H, D, qs, C::kBlockQ);
  if (err == 0) err = tensor_map<C::SW>(&tk, k, B, Sk, H, D, ks, C::BK);
  if (err == 0) err = tensor_map<C::SW>(&tv, v, B, Sk, H, D, vs, C::BK);
  if (err != 0) return err;
  auto kernel = flash_fwd_wgmma_kernel<C>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kBytes);
  int device = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int q_tiles = (Sq + C::kBlockQ - 1) / C::kBlockQ;
  const long long items = (long long)q_tiles * B * H;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  // one resident block per SM, each walking its share of the work items
  const int blocks = (int)(items < sms ? items : sms);
  kernel<<<blocks, C::kThreads, C::kBytes, stream>>>(
      tq, tk, tv, reinterpret_cast<__nv_bfloat16*>(o), H, Sq, Sk, D, q_tiles, (int)items,
      scale * kLog2e, m, l);
  return cudaGetLastError();
}

// ---- Warp-specialised wgmma/TMA kernel, head dims 161 to 512 -----------------
//
// The VAE mid-block (one head, d = 512). 64 query rows per work item; a
// 64 x 512 fp32 accumulator is 256 registers a thread in one warpgroup, so
// two consumer warpgroups share the rows, each owning 256 output columns
// (128 accumulator registers). Each logit is computed once: consumer c takes
// depth slabs 4c..4c+3 of Q K^T (m64n64, 16 k-steps), the two partial S
// tiles are exchanged through shared memory (fp32, 16 KB each) and summed in
// the same order by both, so both hold the same S and run the same softmax
// (one exp2 per logit twice: negligible beside 2048 tensor flops per logit)
// and keep P in registers for P V (m64n256, V's four slabs of the consumer's
// columns, MN-major). Shared memory: Q 64 KB (8 slabs of 64 columns, 128-byte
// swizzle: a TMA box row holds at most 128 bytes), one K and one V tile of 64
// keys (64 KB each) and the exchange (32 KB): 224 KB of the 227. One stage
// each of K and V (rather than two of 32 keys) keeps the wgmma at n64, where
// reading Q from shared memory does not outrun the tensor cores; the producer
// orders its loads K(j+1) before V(j), so K(j+1) lands while P V(j - 1) and
// the softmax of j run and V(j) while Q K^T(j + 1) runs. Persistent blocks,
// one per SM, walk (b, h, query tile) items with the tiles of one (b, h)
// adjacent, so blocks on the card at one time share K/V in L2.
// Bound: at the VAE site (16, 1, 5184, 5184, 512) the tensor cores need
// 0.89 ms; but every 64-row item reads all of its K and V from L2 (10.6 MB,
// 13.8 GB over the 1,296 items), which likely binds first. A 2-CTA cluster
// with TMA multicast of K/V would halve that stream; not done here.
namespace wide {
constexpr int BK = 64;         // keys per tile
constexpr int SW = 128;        // swizzle bytes, one slab row
constexpr int kSlabCols = 64;  // columns per slab
constexpr int kSlabs = 8;      // 512 columns
constexpr int kRows = 64;      // query rows per work item
constexpr int kQSlab = kRows * SW;
constexpr int kKVSlab = BK * SW;
constexpr int kQBytes = kSlabs * kQSlab;
constexpr int kKVBytes = kSlabs * kKVSlab;
constexpr int kKOff = kQBytes;
constexpr int kVOff = kKOff + kKVBytes;
constexpr int kXOff = kVOff + kKVBytes;
constexpr int NSR = BK / 2;       // S accumulator floats per thread
constexpr int NOR = 256 / 2;      // O accumulator floats per thread (256 columns)
constexpr int NP = BK / 4;        // P fragment registers per thread
constexpr int kXBytes = 2 * NSR * 128 * 4;
constexpr int kBarOff = kXOff + kXBytes;
constexpr int kBytes = kBarOff + 6 * 8 + 1024;  // + alignment slack
constexpr int kThreads = 3 * 128;
constexpr int kConsumers = 2 * 128;
static_assert(kBytes <= 232448, "block resources");
}  // namespace wide

__global__ void __launch_bounds__(wide::kThreads, 1)
    flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          __nv_bfloat16* __restrict__ o, int H, int Sq, int Sk, int D,
                          int q_tiles, int items, float scale_log2, float* __restrict__ m_out,
                          float* __restrict__ l_out) {
  using namespace wide;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + kBarOff);
  uint64_t* empty_q = full_q + 1;
  uint64_t* full_k = full_q + 2;
  uint64_t* empty_k = full_q + 3;
  uint64_t* full_v = full_q + 4;
  uint64_t* empty_v = full_q + 5;

  const int nt = (Sk + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 6; i += 2) {
      mbar_init(&full_q[i], 1);
      mbar_init(&full_q[i + 1], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: one thread issues every TMA load; K/V tiles count on
    // across items (`kv`), so each buffer's phase is kv & 1 ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      auto load = [&](uint64_t* full, uint64_t* empty, const CUtensorMap* map, int off, int kv,
                      int row, int h, int b) {
        mbar_wait(empty, (kv & 1) ^ 1);  // the first use passes at once
        mbar_expect_tx(full, kKVBytes);
        for (int s = 0; s < kSlabs; ++s)
          tma_load(smem + off + s * kKVSlab, map, full, kSlabCols * s, row, h, b);
      };
      int kv = 0;
      for (int item = blockIdx.x, it = 0; item < items; item += gridDim.x, ++it, kv += nt) {
        const int bh = item / q_tiles;
        const int q0 = (item - bh * q_tiles) * kRows;
        const int b = bh / H;
        const int h = bh - b * H;
        mbar_wait(empty_q, (it & 1) ^ 1);
        mbar_expect_tx(full_q, kQBytes);
        for (int s = 0; s < kSlabs; ++s)
          tma_load(smem + s * kQSlab, &tm_q, full_q, kSlabCols * s, q0, h, b);
        if (nt > 0) load(full_k, empty_k, &tm_k, kKOff, kv, 0, h, b);
        for (int j = 0; j < nt; ++j) {
          if (j + 1 < nt) load(full_k, empty_k, &tm_k, kKOff, kv + j + 1, (j + 1) * BK, h, b);
          load(full_v, empty_v, &tm_v, kVOff, kv + j, j * BK, h, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows, 256 output columns each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int g = (tid & 31) >> 2;
    const int t = tid & 3;
    // wgmma descriptors of this consumer's halves of Q and K (depth) and of V
    // (columns); a k-step adds its byte offset / 16 to the start address field
    const uint64_t q_desc = smem_desc<SW>(smem_addr(smem) + c * 4 * kQSlab, 16, 8 * SW);
    const uint64_t k_desc = smem_desc<SW>(smem_addr(smem + kKOff) + c * 4 * kKVSlab, 16, 8 * SW);
    const uint64_t v_desc = smem_desc<SW>(smem_addr(smem + kVOff) + c * 4 * kKVSlab, kKVSlab, 8 * SW);
    float* x_mine = reinterpret_cast<float*>(smem + kXOff) + c * NSR * 128 + tid;
    const float* x_other = reinterpret_cast<const float*>(smem + kXOff) + (1 - c) * NSR * 128 + tid;

    float s_acc[NSR];
    float o_acc[NOR];
    uint32_t p_frag[NP];
    float m_lo, m_hi, l_lo, l_hi, alpha_lo, alpha_hi;
    int kv0 = 0;

    // partial S over this consumer's 256 columns of depth: 16 k-steps, four
    // per slab, each 32 bytes further into the slab's swizzled rows. The
    // descriptors are formed at the point of use from opaque copies of the
    // bases: hoisted out of the loop, 32 of them held 64 registers and made
    // ptxas spill.
    auto issue_qk = [&]() {
      uint64_t qd = q_desc, kd = k_desc;
      asm volatile("" : "+l"(qd), "+l"(kd));
      pin<NSR>(s_acc);
      wg_fence();
#pragma unroll
      for (int s = 0; s < 16; ++s)
        wgmma_ss<BK>(s_acc, qd + ((s / 4) * kQSlab + (s % 4) * 32) / 16,
                     kd + ((s / 4) * kKVSlab + (s % 4) * 32) / 16, s > 0);
      wg_commit();
      pin<NSR>(s_acc);
    };
    // O += P V over this consumer's 256 columns: four slabs (LBO) of
    // 64 columns, 8-key groups 8 * SW bytes apart (SBO)
    auto issue_pv = [&]() {
      uint64_t vd = v_desc;
      asm volatile("" : "+l"(vd));
      pin<NOR>(o_acc);
      pin<NP>(p_frag);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs<256>(o_acc, p_frag + 4 * kk, vd + kk * SW);
      wg_commit();
      pin<NOR>(o_acc);
    };
    // the two partial S tiles summed, in one order by both consumers
    auto exchange = [&]() {
#pragma unroll
      for (int i = 0; i < NSR; ++i) x_mine[i * 128] = s_acc[i];
      bar_sync(1, kConsumers);
#pragma unroll
      for (int i = 0; i < NSR; ++i) s_acc[i] += x_other[i * 128];  // a + b == b + a, bit for bit
      bar_sync(2, kConsumers);  // both have read before either writes again
    };
    auto rescale_o = [&]() { rescale<NOR>(o_acc, alpha_lo, alpha_hi); };
    auto softmax = [&](int j) {
      softmax_tile<NSR, BK>(s_acc, scale_log2, j, Sk, t, m_lo, m_hi, l_lo, l_hi, alpha_lo,
                            alpha_hi);
    };
    auto pack = [&]() { pack_p<BK>(p_frag, s_acc); };

    for (int item = blockIdx.x, it = 0; item < items; item += gridDim.x, ++it, kv0 += nt) {
      const int bh = item / q_tiles;
      const int q0 = (item - bh * q_tiles) * kRows;
      const int b = bh / H;
      const int h = bh - b * H;
#pragma unroll
      for (int i = 0; i < NOR; ++i) o_acc[i] = 0.f;
      m_lo = m_hi = -INFINITY;
      l_lo = l_hi = 0.f;
      alpha_lo = alpha_hi = 1.f;

      mbar_wait(full_q, it & 1);
      if (nt > 0) {
        mbar_wait(full_k, kv0 & 1);
        issue_qk();
        wg_wait<0>();
        pin<NSR>(s_acc);
        mbar_arrive(empty_k);
        if (nt == 1) mbar_arrive(empty_q);
        exchange();
        softmax(0);
        pack();
        for (int j = 1; j < nt; ++j) {
          mbar_wait(full_k, (kv0 + j) & 1);
          issue_qk();
          rescale_o();
          mbar_wait(full_v, (kv0 + j - 1) & 1);
          issue_pv();
          wg_wait<1>();  // Q K^T of tile j done; P V of tile j - 1 may run on
          pin<NSR>(s_acc);
          mbar_arrive(empty_k);
          if (j == nt - 1) mbar_arrive(empty_q);  // Q's last use
          exchange();
          softmax(j);
          wg_wait<0>();
          pin<NOR>(o_acc);
          pin<NP>(p_frag);
          mbar_arrive(empty_v);
          pack();
        }
        rescale_o();
        mbar_wait(full_v, (kv0 + nt - 1) & 1);
        issue_pv();
        wg_wait<0>();
        pin<NOR>(o_acc);
        mbar_arrive(empty_v);
      } else {
        mbar_arrive(empty_q);
      }

      // both consumers hold the same (m, l): the first writes the stats
      write_rows<NOR / 4>(o_acc, m_lo, m_hi, l_lo, l_hi, q0 + 16 * warp + g, t, b, h, H, Sq, D,
                          256 * c, m_out != nullptr && c == 0, o, m_out, l_out);
    }
  }
}

int launch_wide(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
                int Sk, int D, const long long* qs, const long long* ks, const long long* vs,
                float scale, float* m, float* l, cudaStream_t stream) {
  using namespace wide;
  CUtensorMap tq, tk, tv;
  if (Sk == 0) k = v = q, ks = vs = qs;  // K/V maps never read: describe q
  int err = tensor_map<SW>(&tq, q, B, Sq, H, D, qs, kRows);
  if (err == 0) err = tensor_map<SW>(&tk, k, B, Sk, H, D, ks, BK);
  if (err == 0) err = tensor_map<SW>(&tv, v, B, Sk, H, D, vs, BK);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_wide_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  int device = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int q_tiles = (Sq + kRows - 1) / kRows;
  const long long items = (long long)q_tiles * B * H;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int blocks = (int)(items < sms ? items : sms);
  flash_fwd_wide_kernel<<<blocks, kThreads, kBytes, stream>>>(
      tq, tk, tv, reinterpret_cast<__nv_bfloat16*>(o), H, Sq, Sk, D, q_tiles, (int)items,
      scale * kLog2e, m, l);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q/k/v strides are (batch, seq, head) in elements; the head dim is contiguous.
// m and l are null, or fp32 (B, Sq, H) outputs for the softmax stats.
// Returns 0 on success, a cudaError_t, -1 for an unsupported head dim, -2 if
// TMA cannot address q, k or v, -3 if the driver has no tensor-map encoder.
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
  // Config<DP, DN, BK, NS, NQ, SW, NC> per head-dim instance (see Config)
  if (D <= 40)
    return launch_wgmma<Config<48, 40, 128, 4, 2, 64, 3>>(q, k, v, o, B, H, Sq, Sk, D, qs, ks, vs, scale, mf, lf, st);
  if (D <= 64)
    return launch_wgmma<Config<64, 64, 128, 3, 2, 128, 2>>(q, k, v, o, B, H, Sq, Sk, D, qs, ks, vs, scale, mf, lf, st);
  if (D <= 80)
    return launch_wgmma<Config<80, 80, 128, 3, 2, 32, 2>>(q, k, v, o, B, H, Sq, Sk, D, qs, ks, vs, scale, mf, lf, st);
  if (D <= 160)
    return launch_wgmma<Config<160, 160, 64, 2, 2, 128, 2>>(q, k, v, o, B, H, Sq, Sk, D, qs, ks, vs, scale, mf, lf, st);
  if (D <= 512) return launch_wide(q, k, v, o, B, H, Sq, Sk, D, qs, ks, vs, scale, mf, lf, st);
  return -1;
}

const char* musev_cuda_error_string(int err) {
  if (err == -1) return "unsupported head dim";
  if (err == kTensorMapError) return "cuTensorMapEncodeTiled refused a q/k/v layout";
  if (err == kNoEncoder) return "the CUDA driver has no cuTensorMapEncodeTiled";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
