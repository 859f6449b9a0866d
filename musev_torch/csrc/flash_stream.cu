// Long-KV streaming flash attention for Hopper (sm_90a): a thread-block
// cluster holds a large query chunk resident and streams K/V past it once,
// each K/V tile loaded from device memory once per cluster by TMA multicast.
// bf16 in/out, fp32 logits, softmax state and accumulator.
//
// Replaces the Pallas TPU kernel _stream_kernel
// (musev_tpu/ops/pallas/flash_attention.py:165, driven by _flash_stream
// :255-294). Its idea is one program that owns a large resident q chunk
// (bq_inner rows) and streams the whole KV extent past it once, copies
// double-buffered against compute, every q sub-block's online-softmax state
// carried on chip. On Hopper one CTA holds at most 192 query rows (three
// 64-row consumer warpgroups), so the chunk becomes a cluster of CN CTAs on
// neighbouring SMs: together they own CN x 64 * NC consecutive query rows of
// one (b, h) (384 at d = 40 with CN = 2; 576, the TPU kernel's bq_inner, with
// CN = 3), and each K/V tile reaches all CN shared memories from one TMA
// multicast.
//
// Bound. At the L0 ReferenceNet fuse site (B 78, H 8, sq 5184, sk 10368,
// d 40) the tensor cores need 5.4 ms and one exp2 per logit 8.6 ms (3.9 T
// exp2/s; flash_attention.cu's note). The third limit, the one this design
// is about, is the K/V stream from L2 into shared memory: a CTA of 192 rows
// reads each (b, h)'s K/V (1.66 MB) 27 times, 28 GB at that site, against
// 14 GB for a cluster of 384 rows and 9.3 GB for one of 576.
//
// Design (flash_stream_kernel):
//   * Each CTA is flash_attention.cu's flash_fwd_wgmma_kernel: a producer
//     warpgroup (setmaxnreg 24), NC consumer warpgroups of 64 rows, Q K^T as
//     wgmma m64nBKk16 from shared memory, P V with P from registers, a ring
//     of NS K/V stages; the plan per head dim is that kernel's Config.
//   * Work items are per cluster (%clusterid): a (b, h) and a chunk of
//     CN x 64 * NC query rows; CTA r of the cluster takes the chunk's r-th
//     64 * NC rows. Persistent clusters, as many as
//     cudaOccupancyMaxActiveClusters allows, walk the items, the chunks of
//     one (b, h) adjacent.
//   * K/V loads. Every CTA's issuing thread waits until every CTA of the
//     cluster has released the slot (below) and sets its own full barrier to
//     expect the whole tile's bytes; the tile is issued once in the cluster
//     with cp.async.bulk.tensor...multicast::cluster to all CN CTAs, by CTA
//     kv mod CN, kv the tile's place in the ring's sequence (each CTA a
//     share of every tile instead ran no faster: chip_stream_ablation.py).
//     A multicast may land before the receiving producer's expect_tx: the
//     phase stays open until that producer arrives.
//   * Releasing a slot. A slot is refilled only when every CTA of the
//     cluster has released it. The consumers release it on their own CTA's
//     empty barrier, exactly as in the flash kernel; a forwarding thread
//     (warp 1 of the producer warpgroup) waits on that barrier and passes
//     each release on to the cluster-wide empty barrier of every CTA (mapa,
//     mbarrier.arrive.shared::cluster), which counts CN arrivals a use; the
//     issuing thread waits only on its own cluster-wide barrier. So the
//     consumers keep the flash kernel's code and registers, and no consumer
//     arrives across SMs. Q is per CTA (not shared) and keeps local
//     barriers.
//   * Idle CTAs. A CTA whose rows all lie past sq (L1 sq = 1296, L3 sq = 81,
//     short tails) still sets up its barriers, expects every tile and
//     releases every slot once its copy has landed (a multicast into the
//     shared memory of an exited CTA is undefined); its consumers skip the
//     products by a branch around the whole item, never among the wgmma.
//     Every CTA ends on barrier.cluster arrive/wait, so none exits while a
//     peer may still multicast into it or arrive on its barriers.
//   * As in the flash kernel: no branch among the wgmma (the ragged key
//     tail is masked in the softmax), descriptors formed at the point of use.
//
// The cluster size CN is fixed per head-dim instance (kClusterSize, from
// chip_stream_ablation.py's sweep, PERF.md §6). A row whose keys are all
// masked (sk = 0) yields 0.

#include "flash_common.cuh"

namespace {

constexpr int kNoClusterFits = -4;

// This CTA's rank in its cluster, the cluster's index in the grid and the
// number of clusters.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ int cluster_index() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return (int)r;
}

// Every thread of every CTA of the cluster; release/acquire (the defaults).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}

// One TMA box into the same shared-memory offset of every CTA in `mask`,
// completing on the barrier at `bar`'s offset in each of them.
__device__ __forceinline__ void tma_load_multicast(void* dst, const CUtensorMap* map,
                                                   uint64_t* bar, uint16_t mask, int c0, int c1,
                                                   int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6, %7}], [%2], %3;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "h"(mask), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Arrive on the barrier at `bar`'s offset in CTA `cta` of the cluster, with
// the default semantics (release at CTA scope). A .release.cluster arrive
// compiles to MEMBAR.ALL.GPU, which per slot release doubled the kernel's
// time (PERF.md §6); the order it would add is not needed: the slot's
// readers have finished (wgmma.wait_group, then the local empty barrier)
// before this arrive is issued, and the only write that follows is the TMA.
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_addr(bar)),
      "r"(cta)
      : "memory");
}

// Shared memory: the flash kernel's layout (Config) and, after its barriers,
// the cluster-wide empty barriers of the K and V slots.
template <class C>
constexpr int kStreamBytes = C::kBytes + 2 * C::NS * 8;

template <class C, int CN>
__global__ void __launch_bounds__(C::kThreads, 1)
    flash_stream_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        __nv_bfloat16* __restrict__ o, int H, int Sq, int Sk, int D,
                        int chunks, int items, float scale_log2) {
  constexpr int DP = C::DP, DN = C::DN, BK = C::BK, NS = C::NS, NQ = C::NQ, SW = C::SW;
  constexpr int NC = C::NC;
  constexpr int kSlabs = C::kSlabs;
  constexpr int kSlabCols = C::kSlabCols;
  constexpr int NSR = BK / 2;     // S accumulator floats per thread (m64 x BK)
  constexpr int NOR = DN / 2;     // O accumulator floats per thread (m64 x DN)
  constexpr int NP = BK / 4;      // P fragment registers per thread
  constexpr int kTurn = 128 * 2;  // threads at a turn barrier

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(smem + C::kBarOff);
  uint64_t* empty_q = full_q + NQ;
  uint64_t* full_k = empty_q + NQ;
  uint64_t* full_v = full_k + NS;
  uint64_t* empty_k = full_v + NS;
  uint64_t* empty_v = empty_k + NS;
  uint64_t* cluster_empty_k = empty_v + NS;  // released by every CTA of the cluster
  uint64_t* cluster_empty_v = cluster_empty_k + NS;

  // the cluster's registers are read where they are used: a value live
  // across setmaxnreg, or kept by the 24-register producer, is spilled
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
      mbar_init(&cluster_empty_k[s], CN);
      mbar_init(&cluster_empty_v[s], CN);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every peer's barriers exist before any multicast or remote arrive

  if (wg == 0) {
    // ---- producer warpgroup, 24 registers: the cluster's registers are
    // read at their uses ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      // ---- issuer: this CTA's Q, and every K/V tile whose turn it is ----
      // Every slab of a tile is issued by CTA `r` of the cluster.
      auto issue = [&](unsigned char* dst, const CUtensorMap* map, uint64_t* full, uint32_t r,
                       int row, int h, int b) {
        mbar_expect_tx(full, C::kKVBytes);
        for (int s = 0; s < kSlabs; ++s)
          if (r == cluster_rank())
            tma_load_multicast(dst + s * C::kKVSlab, map, full, (1u << CN) - 1, kSlabCols * s,
                               row, h, b);
      };
      int kv = 0;
      for (int item = cluster_index(), it = 0; item < items; item += cluster_count(), ++it) {
        const int bh = item / chunks;
        const int q0 = ((item - bh * chunks) * CN + cluster_rank()) * C::kBlockQ;
        const int b = bh / H;
        const int h = bh - b * H;
        const int qb = it % NQ;
        mbar_wait(&empty_q[qb], ((it / NQ) & 1) ^ 1);  // the first use passes at once
        if (q0 < Sq) {
          mbar_expect_tx(&full_q[qb], C::kQBytes);
          for (int s = 0; s < kSlabs; ++s)
            tma_load(smem + qb * C::kQBytes + s * C::kQSlab, &tm_q, &full_q[qb], kSlabCols * s,
                     q0, h, b);
        } else {
          mbar_arrive(&full_q[qb]);  // no rows here: nothing to load
        }
        for (int j = 0; j < nt; ++j, ++kv) {
          const int st = kv % NS;
          const uint32_t ph = (kv / NS) & 1;
          // every CTA has released the slot's last tile (the first use passes at once)
          mbar_wait(&cluster_empty_k[st], ph ^ 1);
          issue(smem + C::kKOff + st * C::kKVBytes, &tm_k, &full_k[st], kv % CN, j * BK, h, b);
          mbar_wait(&cluster_empty_v[st], ph ^ 1);
          issue(smem + C::kVOff + st * C::kKVBytes, &tm_v, &full_v[st], kv % CN, j * BK, h, b);
        }
      }
    } else if (threadIdx.x == 32) {
      // ---- forwarder: passes each release of a K/V slot by this CTA's
      // consumers on to every CTA's cluster-wide empty barrier, in the
      // ring's sequence (tile kv is released in phase kv / NS of `empty`) ----
      const int n_kv = nt * ((items - cluster_index() + cluster_count() - 1) / cluster_count());
      for (int kv = 0; kv < n_kv; ++kv) {
        const int st = kv % NS;
        const uint32_t ph = (kv / NS) & 1;
        mbar_wait(&empty_k[st], ph);
        for (uint32_t r = 0; r < CN; ++r) mbar_arrive_remote(&cluster_empty_k[st], r);
        mbar_wait(&empty_v[st], ph);
        for (uint32_t r = 0; r < CN; ++r) mbar_arrive_remote(&cluster_empty_v[st], r);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(C::kConsumerRegs) : "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int g = (tid & 31) >> 2;
    const int t = tid & 3;
    const int my_turn = 1 + c;
    const int next_turn = 1 + (c + 1) % NC;
    const uint32_t k_base = smem_addr(smem + C::kKOff);
    const uint32_t v_base = smem_addr(smem + C::kVOff);

    float s_acc[NSR];
    float o_acc[NOR];
    uint32_t p_frag[NP];
    float m_lo, m_hi, l_lo, l_hi, alpha_lo, alpha_hi;
    uint32_t q_base = 0;
    int kv0 = 0;

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
    auto wait_k = [&](int j) { mbar_wait(&full_k[(kv0 + j) % NS], ((kv0 + j) / NS) & 1); };
    auto wait_v = [&](int j) { mbar_wait(&full_v[(kv0 + j) % NS], ((kv0 + j) / NS) & 1); };
    auto release_k = [&](int j) { mbar_arrive(&empty_k[(kv0 + j) % NS]); };
    auto release_v = [&](int j) { mbar_arrive(&empty_v[(kv0 + j) % NS]); };

    for (int item = cluster_index(), it = 0; item < items;
         item += cluster_count(), ++it, kv0 += nt) {
      const int bh = item / chunks;
      const int q0 = ((item - bh * chunks) * CN + cluster_rank()) * C::kBlockQ;
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
      if (nt > 0 && q0 < Sq) {
        if (c == NC - 1) bar_arrive(1, kTurn);
        wait_k(0);
        bar_sync(my_turn, kTurn);
        issue_qk(0);
        bar_arrive(next_turn, kTurn);
        wg_wait<0>();
        pin<NSR>(s_acc);
        release_k(0);
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
          release_k(j);
          if (j == nt - 1) mbar_arrive(&empty_q[qb]);
          softmax(j);
          wg_wait<0>();
          pin<NOR>(o_acc);
          pin<NP>(p_frag);
          release_v(j - 1);
          pack();
        }
        rescale_o();
        wait_v(nt - 1);
        bar_sync(my_turn, kTurn);
        issue_pv(nt - 1);
        if (c != NC - 1) bar_arrive(next_turn, kTurn);
        wg_wait<0>();
        pin<NOR>(o_acc);
        release_v(nt - 1);
        write_rows<DN / 8>(o_acc, m_lo, m_hi, l_lo, l_hi, q0 + 64 * c + 16 * warp + g, t, b, h,
                           H, Sq, D, 0, false, o, nullptr, nullptr);
      } else {
        // no keys, or no rows in this CTA: release every slot once its copy
        // has landed, so that the peers' ring keeps turning
        for (int j = 0; j < nt; ++j) {
          wait_k(j);
          release_k(j);
          wait_v(j);
          release_v(j);
        }
        mbar_arrive(&empty_q[qb]);
        if (nt == 0)  // sk = 0: every row is 0 (rows past sq are not written)
          write_rows<DN / 8>(o_acc, m_lo, m_hi, l_lo, l_hi, q0 + 64 * c + 16 * warp + g, t, b,
                             h, H, Sq, D, 0, false, o, nullptr, nullptr);
      }
    }
  }
  cluster_sync();  // no CTA exits while a peer may still write into it
}

// Launches instance C in clusters of CN CTAs; `info`, when given,
// receives the plan: cluster size, query rows per CTA and the clusters the
// card holds at once (cudaOccupancyMaxActiveClusters). A null q launches
// nothing.
template <class C, int CN>
int launch_stream(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq,
                  int Sk, int D, const long long* qs, const long long* ks, const long long* vs,
                  float scale, int* info, cudaStream_t stream) {
  static_assert(CN >= 1 && CN <= 8, "a portable cluster holds 1 to 8 CTAs");
  auto kernel = flash_stream_kernel<C, CN>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kStreamBytes<C>);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CN;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CN);
  cfg.blockDim = dim3(C::kThreads);
  cfg.dynamicSmemBytes = kStreamBytes<C>;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int active = 0;  // clusters the card holds at once (one device per process)
  if (active == 0) {
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (n <= 0) return kNoClusterFits;
    active = n;
  }
  if (info != nullptr) {
    info[0] = CN;
    info[1] = C::kBlockQ;
    info[2] = active;
  }
  if (q == nullptr) return 0;

  CUtensorMap tq, tk, tv;
  if (Sk == 0) k = v = q, ks = vs = qs;  // K/V maps never read: describe q
  int err = tensor_map<C::SW>(&tq, q, B, Sq, H, D, qs, C::kBlockQ);
  if (err == 0) err = tensor_map<C::SW>(&tk, k, B, Sk, H, D, ks, C::BK);
  if (err == 0) err = tensor_map<C::SW>(&tv, v, B, Sk, H, D, vs, C::BK);
  if (err != 0) return err;
  const int rows = CN * C::kBlockQ;
  const int chunks = (Sq + rows - 1) / rows;
  const long long items = (long long)chunks * B * H;
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int clusters = (int)(items < active ? items : active);
  cfg.gridDim = dim3(clusters * CN);
  e = cudaLaunchKernelEx(&cfg, kernel, tq, tk, tv, reinterpret_cast<__nv_bfloat16*>(o), H, Sq,
                         Sk, D, chunks, (int)items, scale * kLog2e);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The cluster size of each head-dim instance, from chip_stream_ablation.py's
// sweep (PERF.md §6): 2 up to d = 80, the only size whose clusters cover all
// 132 SMs (3 and 4 leave 15 and 12 idle); 3 at d = 160, whose one site that
// streams (L2, sq 324) fits one chunk of 384 rows where 2 needs two.
constexpr int kClusterSize[4] = {2, 2, 2, 3};

// Config<DP, DN, BK, NS, NQ, SW, NC> per head-dim instance, as in
// flash_attention.cu.
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int H, int Sq, int Sk,
             int D, const long long* qs, const long long* ks, const long long* vs, float scale,
             int* info, cudaStream_t st) {
  if (D <= 0 || D % 8 != 0 || D > 160) return -1;
  if (D <= 40)
    return launch_stream<Config<48, 40, 128, 4, 2, 64, 3>, kClusterSize[0]>(q, k, v, o, B, H, Sq, Sk, D, qs, ks, vs, scale, info, st);
  if (D <= 64)
    return launch_stream<Config<64, 64, 128, 3, 2, 128, 2>, kClusterSize[1]>(q, k, v, o, B, H, Sq, Sk, D, qs, ks, vs, scale, info, st);
  if (D <= 80)
    return launch_stream<Config<80, 80, 128, 3, 2, 32, 2>, kClusterSize[2]>(q, k, v, o, B, H, Sq, Sk, D, qs, ks, vs, scale, info, st);
  return launch_stream<Config<160, 160, 64, 2, 2, 128, 2>, kClusterSize[3]>(q, k, v, o, B, H, Sq, Sk, D, qs, ks, vs, scale, info, st);
}

}  // namespace

extern "C" {

// q/k/v strides are (batch, seq, head) in elements; the head dim is contiguous.
// Returns 0 on success, a cudaError_t, -1 for an unsupported head dim, -2 if
// TMA cannot address q, k or v, -3 if the driver has no tensor-map encoder,
// -4 if no cluster of the instance's size fits on the card.
int musev_flash_stream_bf16(const void* q, const void* k, const void* v, void* o, int B, int H,
                            int Sq, int Sk, int D, long long q_sb, long long q_ss,
                            long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh, float scale,
                            void* stream) {
  const long long qs[3] = {q_sb, q_ss, q_sh};
  const long long ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh};
  return dispatch(q, k, v, o, B, H, Sq, Sk, D, qs, ks, vs, scale, nullptr,
                  reinterpret_cast<cudaStream_t>(stream));
}

// The plan of head dim D into out[3]: cluster size, query rows per CTA,
// clusters the card holds at once. Same return codes.
int musev_flash_stream_plan(int D, int* out) {
  return dispatch(nullptr, nullptr, nullptr, nullptr, 0, 0, 0, 0, D, nullptr, nullptr, nullptr,
                  1.f, out, nullptr);
}

const char* musev_cuda_error_string(int err) {
  if (err == -1) return "unsupported head dim";
  if (err == kTensorMapError) return "cuTensorMapEncodeTiled refused a q/k/v layout";
  if (err == kNoEncoder) return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (err == kNoClusterFits) return "no thread-block cluster of the plan fits on the card";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
