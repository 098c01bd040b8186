// Decode on Hopper (sm_90a) with a bf16 query: one query token per
// sequence against bf16 K/V page pools (P, Hkv, psz, D), or int8 pools with
// per-row fp32 scales (P, Hkv, psz), each sequence reaching its pages
// through a row of a page table (B, nblk) int32; or against dense bf16
// strips (B, Hkv, S, D).  Plain C interface, bound from Python with ctypes
// (kernels/paged_attention.py, kernels/flash_attention.py); no PyTorch
// headers.
//
// Replaces the Pallas kernels of src/repro/kernels/flash_attention.py:
// K3  paged_decode_tc_kernel<bf16, D, PAGED>     flash_paged_decode (:434) /
//                                   _paged_decode_kernel (pallas_call :491)
// K6a paged_decode_tc_kernel<int8, D, PAGED>     flash_paged_decode_quant
//                                   (:897) / _paged_decode_quant_kernel (:951)
//     both at num_splits = 1;
// K2  paged_decode_tc_kernel<bf16, D, DENSE>     flash_decode (:203) /
//                                   _decode_kernel (pallas_call :233);
// K5a paged_decode_tc_kernel<bf16, D, PARTIALS>  flash_paged_decode (:434,
//                                   num_splits > 1) /
//                                   _paged_decode_split_kernel (:535);
// K6b paged_decode_tc_kernel<int8, D, PARTIALS>  flash_paged_decode_quant
//                                   (:897, num_splits > 1) /
//                                   _paged_decode_split_quant_kernel
//                                   (pallas_call :1001, body :850);
// K5c, in the PARTIALS epilogue of the merged entries: _combine_splits
//                                   (:304) / _split_combine_kernel (:315).
// A float32 query keeps the SIMT templates of paged_attention.cu and
// flash_attention.cu (a TF32 product would break the fp32 tolerance); the
// wrappers pick by the query's type.
//
// The three modes share every mechanism below and differ only where the
// rows come from and where the state goes:
//  PAGED     rows through the page table, the cluster merges its ranks'
//            states through distributed shared memory and stores o;
//  DENSE     a strip (B, Hkv, S, D) is a pool of B pages of S keys with
//            table[b] = b, so row (b, hk, key) is (b * Hkv + hk) * S + key
//            and no table is staged; kv_len is clamped to [0, S] and S
//            need not be a multiple of the key tile (the copies
//            zero-fill the tail);
//  PARTIALS  paged rows (bf16 pools: K5a; int8 pools with their scales:
//            K6b), one CTA per split in a cluster of one (grid
//            B * Hkv * ns): split s walks the s-th contiguous share,
//            ceil(tiles / ns), of the lane's live key tiles (the rank
//            rule with c replaced by ns); after the in-CTA warp merge it
//            stores its (m, l, acc) as fp32 partials m, l (B, Hkv, ns, G),
//            acc (.., D), m in natural-log units as K5c
//            (paged_attention.cu's split_combine_kernel) reads them, and
//            skips both cluster barriers.  An empty split stores (-1e30,
//            0, 0); only the G live rows of a slab are stored.  Given the
//            arrival counters (the merged entries), K5c's merge follows in
//            the epilogue: the last of the ns splits of a (lane, kv head,
//            slab) to finish, counted by an atomic, merges them as K5c
//            does (common.cuh's merge_splits_if_last) and stores o, so a
//            split decode is one launch.
//
// Semantics of the TPU kernels: key j of sequence b lives in page
// table[b, j / psz] at slot j % psz; only keys j < kv_len[b] are read
// (table entries past ceil(kv_len / psz) are never read); masked scores
// are -1e30; the softmax statistics are fp32; a lane with kv_len == 0
// gives exactly 0; GQA maps query head h to kv head h / (H / Hkv).
// Rounding, as paged_prefill.cu's: Q.K^T and P.V are bf16 products summed
// in fp32 (int8 codes are exact in bf16); for int8 pools the key scale
// multiplies column j of S after the product and the value scale is folded
// into P before P is rounded to bf16; the row sums l come from the fp32 P.
// So an output moves by at most 2^-8 sum_j p_j |v_j| / l from the plain
// fp32 version's.
//
// The key tile BN is a template parameter, the run-time AT's block_k
// (tuning/dynamic.py's DecodeBucket regions, KVPrecision): 64 keys (the
// default: 4 warps of 16 keys), and at D = 128 and 160 also 32 (2 warps
// of 16).  D = 80 (h2o-danube-1.8b) and D = 112 (zamba2-7b's shared
// block) have their own DENSE mode (K2) alone, at both tiles: their
// sliding windows keep a ring of 4096 slots a lane in a dense strip and
// never page (a paged D 80 or 112 runs on the padded instances of widths
// 96 and 128, which every mode has at every width of common.cuh's
// with_pad_width, 64 keys a tile).  D = 160 (pixtral-12b) pages and has
// every mode.  Above 256 the wide rungs 384 and 512 (32 keys, the head
// dim split across warps; dec's notes below, common.cuh).  The body takes
// them as they are: 5 (7, 10) k-steps of m16n8k16 for S, 10 (14, 20)
// n-tiles for P.V, rows of 176 (240, 336) bytes, 11 (15, 21) 16-byte
// chunks apart, 20 (28, 40) float4 columns a row in the merge.  At D =
// 160 the bf16 ring of the 64-key tile (129,024 B, with the Q slab
// 134,400) leaves one CTA an SM, and so does the int8 one (117,504 B);
// the 32-key tiles leave three (kernels/paged_attention.py's
// decode_ctas_per_sm reckons the same, for the cluster rule).
// A warp is one key group with its own online
// softmax, so the tile sets where the fp32 sums and P's bf16 rounding
// fall, and the rank and split rules cut the lane's live BN-key tiles.
// The description below is at BN = 64.
//
// What bounds it on an H100.  At the serve's shape (yi-6b: four lanes of
// 839, 720, 190 and 544 keys, H 32, Hkv 4, D 128, pages of 16) a decode
// step must read 4.7 MB of bf16 K/V once (half in int8): 0.0014 ms at 3.35
// TB/s; its products take 0.00004 ms at 989 TFLOP/s.  So it is bound by
// bytes, and what a kernel pays above that is latency: the launch, the
// dependent loads of kv_len, the page table and the pages, the serial
// walk over key tiles.  The SIMT template ran at 66x that bound for three
// reasons; the design answers each:
//  1. too few blocks (one per lane and kv head: 16 of 132 SMs) -> one
//     thread-block cluster of c CTAs per (lane, kv head, 16 query rows),
//     c chosen on the host from the shapes alone (kernels/paged_attention.py
//     cluster_size: the largest of 1, 2, 4, 8 with B * Hkv * c <= the CTAs
//     the card holds at once, two an SM, or one where the instance's
//     shared memory leaves one (D = 160 at 64 keys); 8 at yi-6b's four
//     lanes, 128 CTAs; 2 at deepseek-7b's, 256; 4 at pixtral-12b's, 128).
//     CTA rank r walks the
//     r-th contiguous share of the lane's live 64-key tiles, ceil(tiles /
//     c) of them (the last ranks possibly none), and merges its warps'
//     (m, l, acc) in its own shared memory; after a cluster barrier each
//     rank reads every rank's (m, l) through distributed shared memory,
//     takes each rank's weight e^(m_k - m*) / l* per row once, and stores
//     its share of the G x D outputs as the weighted sum of the ranks' acc
//     rows (4 columns a thread); a second cluster barrier keeps every CTA's
//     shared memory alive until its peers have read it.  One launch, one
//     pass, no partials in device memory, no combine kernel;
//  2. synchronous loads, one key row per lane -> each warp owns 16 keys of
//     every 64-key tile (its key group) and brings them itself: 16-byte
//     cp.async copies of its K and V rows, each row found through the
//     page-table entries staged in shared memory once, into rows padded
//     by 16 bytes (conflict-free ldmatrix), keys past kv_len zero-filled
//     by the copy (so slots past kv_len are never read, and a masked
//     key's P of 0 meets a zero row, never a stale one); int8 codes are
//     widened to bf16 in shared memory by the warp, and their row scales
//     arrive by 4-byte copies beside them.  A ring of 3 stages keeps the
//     next 2 tiles in flight while one is multiplied (at yi-6b's lanes a
//     rank's whole share).  A warp reads only the rows it copied, so the
//     walk has no block-wide barrier.  Whole pages by bulk copies
//     (cp.async.bulk, one thread issuing a copy per page run, counted on
//     an mbarrier) were built and measured first: their unpadded rows
//     need a restaging pass, and they were slower at the serve's shape
//     (PERF.md, the K3/K6a redesign);
//  3. SIMT fp32 products with a shuffle per key -> mma.sync.m16n8k16 bf16
//     with fp32 accumulators, the G query rows of the kv head padded to one
//     16-row slab (G > 16: one cluster per 16 rows, grid y), Q's fragments
//     loaded once; each of the 4 warps takes 16 keys of every tile (its key
//     group), S and the online softmax in fp32 registers (exp2, row max by
//     quad shuffles), P packed to bf16 in registers as the A operand of P.V
//     (V by ldmatrix.trans).  Not wgmma: its 64-row minimum would waste at
//     least 4x the products on G <= 16 rows, and decode is bound by bytes.
// K2 (the SIMT flash_decode_kernel of flash_attention.cu, 16 blocks at
// yi-6b's four dense lanes) and K5a and K6b (the SIMT template of
// paged_attention.cu with a split axis) had the same three faults; they
// are now the DENSE and PARTIALS modes of this kernel, with no new body:
// K2 launches exactly as K3 does, with no table and no extra allocation,
// and K5a is K3's walk with its splits in place of a cluster's ranks, K6b
// the same walk over K6a's int8 rows (widened in shared memory, scales by
// 4-byte copies; a key past kv_len has its scales zero-filled by the
// copy, so a NaN scale there is never read).
// K5c (paged_attention.cu's split_combine_kernel, a launch of its own
// after K5a or K6b: one block per row, each of its 128 threads repeating
// the row's ns exps) ran at 54x its bound, 0.009 ms at 8 splits, 43% of a
// split decode: a second launch, two dependent rounds of loads of
// partials phase 1 had just written.  Those partials are still in L2, so
// the merge moved into the PARTIALS epilogue behind an arrival counter per
// (lane, kv head, slab): no CTA waits (no co-residency is assumed), the
// last one merges (one warp a row for m*, the weights and l*; 4 columns a
// thread for acc, in split order) and resets its counter, so the
// workspace is all zeros between launches and no launch clears it.  The int8 PARTIALS instance
// needs 96,000 bytes of shared memory before the table at D = 128 (the
// int8 ring, the widened tiles, the Q slab and the scales), less than
// the bf16 one's 108,800, so it keeps two CTAs an SM.

#include <cooperative_groups.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

namespace dec {
constexpr int STAGES = 3;
constexpr int ROWS = 16;             // query rows per CTA: one mma slab
constexpr int MAX_CLUSTER = 8;
constexpr float kLn2 = 0.6931471805599453f;
// what a launch computes (the kernel's MODE; see the head of this file)
constexpr int PAGED = 0, DENSE = 1, PARTIALS = 2;
constexpr int DEFAULT_BN = 64;       // the key tile of an untuned launch

// The key tile BN (keys per ring stage) and the warps that share it: each
// warp is one key group, taking KN = 16 consecutive keys of every tile,
// so a tile of 32 keys has 2 warps and one of 64 has 4 (NT 8-key column
// tiles of S each).
template <int BN_>
struct Tile {
  static constexpr int BN = BN_;
  static constexpr int KN = 16;
  static constexpr int NWARPS = BN / KN;
  static constexpr int THREADS = NWARPS * 32;
  static constexpr int NT = KN / 8;
  static_assert(BN % KN == 0, "a tile is whole 16-key mma steps");
};

// The wide instances (D > 256, common.cuh): each key group is served by
// head_slices<D>() warps, one per 128 columns, each copying, widening and
// multiplying its own columns of the group's rows (so a warp still reads
// only what it copied); their partial S meet in shared memory at the
// group's named barrier, in one of two buffers by key step (no block
// barrier frees them between steps).  One tile, 32 keys (2 groups), and a
// ring of 2 stages, so that the CTA fits: 166,144 B of shared memory at D
// = 512 over bf16 pools (169,216 over int8; 125,184 and 127,744 at 384)
// before the table, one CTA an SM, 256 (192) threads of 32 Q fragment
// registers and 64 fp32 of O each (ptxas: 157-167 registers in the one-
// pass and dense modes, 210-214 in the partials mode, no spill).
constexpr int WIDE_BN = 32;
template <int D>
__host__ __device__ constexpr int stages() { return D > 256 ? 2 : STAGES; }
template <int D, int BN>
__host__ __device__ constexpr int threads() {
  return Tile<BN>::THREADS * head_slices<D>();
}

// Dynamic shared memory of one CTA, in bytes: the ring of K and V stages
// as the copies land them (rows of D * sizeof(S) + 16 bytes), for int8
// pools the K and V tiles widened to bf16 rows of D + 8, the Q slab, for
// int8 pools the ring's key and value scales, then the page-table entries
// of the rank's share.  After the walk the space below the table holds the
// softmax states of the 4 warps and then the CTA's merged one, each
// m[ROWS], l[ROWS], acc[ROWS][SROW] in fp32, then the ranks' weights
// [MAX_CLUSTER][ROWS].
template <typename S, int D, int BN>
struct Smem {
  static constexpr int NWARPS = Tile<BN>::NWARPS;            // key groups
  static constexpr int NS = head_slices<D>();
  static constexpr int NSTG = stages<D>();
  static constexpr bool QUANT = std::is_same_v<S, int8_t>;
  static constexpr int ROW = D + 8;                          // bf16 elements
  static constexpr int KV_ROW = D * (int)sizeof(S) + 16;     // bytes
  static constexpr size_t stage_bytes = (size_t)BN * KV_ROW; // K or V
  static constexpr size_t wide_bytes = QUANT ? (size_t)BN * ROW * 2 : 0;
  static constexpr size_t kw_off = 2 * NSTG * stage_bytes;
  static constexpr size_t vw_off = kw_off + wide_bytes;
  static constexpr size_t q_off = vw_off + wide_bytes;
  static constexpr size_t sc_off = q_off + (size_t)ROWS * ROW * 2;
  // the ring's scales, one copy a slice; then (wide) the slices' partial S
  // of each key group, two buffers (sum_slices)
  static constexpr size_t sp_off =
      sc_off + (QUANT ? (size_t)NS * NSTG * 2 * BN * 4 : 0);
  static constexpr size_t sp_bytes =
      D > 256 ? (size_t)2 * NWARPS * NS * Tile<BN>::KN * 16 * 4 : 0;
  static constexpr size_t tbl_off = sp_off + sp_bytes;
  static constexpr int SROW = D + 4;
  static constexpr int STATE = ROWS * (2 + SROW);            // floats
  static_assert(((size_t)(NWARPS + 1) * STATE + MAX_CLUSTER * ROWS) * 4 <=
                    tbl_off,
                "merge space");
};
}  // namespace dec

// ---------------------------------------------------------------------------
// K3 / K6a / K2 / K5a / K6b: q (B, H, 1, D) bf16, pools (P, Hkv, psz, D) of S
// (bf16, or int8 with scales (P, Hkv, psz) fp32), table (B, nblk), kv_len
// (B,) int32; o (B, H, 1, D) bf16.  DENSE: the pools are the strips (B,
// Hkv, S, D), psz = S, nblk = 1, no table.  Grid (B * Hkv * c, ceil(G /
// 16)) in clusters of (c, 1, 1): cluster blockIdx.x / c is (lane, kv
// head), its rank the share of the key tiles; blockIdx.y the 16 query
// rows.  PARTIALS: c = ns in clusters of one, blockIdx.x % ns the split,
// partials pm, pl, pacc in place of o; with cnt (B * Hkv * ceil(G / 16)
// int32 arrival counters, zero on entry and left zero) also o, K5c's merge
// of the splits.  scale_log2 = scale * log2(e), so the softmax runs on
// exp2.
// ---------------------------------------------------------------------------

template <typename S, int D, int MODE, int BN, bool PAD>
__global__ void __launch_bounds__(dec::threads<D, BN>())
paged_decode_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const S* __restrict__ kp, const S* __restrict__ vp,
                       const float* __restrict__ ksc,
                       const float* __restrict__ vsc,
                       const int* __restrict__ table,
                       const int* __restrict__ kv_len,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ pm,
                       float* __restrict__ pl, float* __restrict__ pacc,
                       int* __restrict__ cnt, int H, int Hkv, int psz,
                       int nblk, int ns, float scale_log2, int d_run) {
  using namespace dec;
  const int d = PAD ? d_run : D;     // the row stride (common.cuh)
  using L = Smem<S, D, BN>;
  constexpr bool WIDE = D > 256;     // the head dim split across warps
  constexpr int NS = L::NS;          // column slices of a key group
  constexpr int SW = D / NS;         // a slice's columns
  constexpr int NSTG = L::NSTG;      // ring stages
  constexpr int NWARPS = Tile<BN>::NWARPS;   // key groups
  constexpr int THREADS = threads<D, BN>();
  constexpr int KN = Tile<BN>::KN;   // keys per key group (a warp's)
  constexpr int NT = Tile<BN>::NT;   // 8-key column tiles of a group's S
  constexpr bool QUANT = L::QUANT;
  constexpr int ROW = L::ROW;
  constexpr int SROW = L::SROW;
  constexpr int CH = D / 8;          // 8-element chunks of a row
  constexpr int CHS = SW / 8;        // and of a slice
  constexpr int DT = SW / 8;         // 8-wide column tiles of O
  constexpr int KT = SW / 16;        // 16-deep steps of Q.K^T
  static_assert(D % 16 == 0, "tile shape");

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  float* sc = reinterpret_cast<float*>(smem + L::sc_off);
  int* tbl = reinterpret_cast<int*>(smem + L::tbl_off);
  constexpr int KV_ROW = L::KV_ROW;
  constexpr int CPS = SW * (int)sizeof(S) / 16;  // 16-byte copies per slice

  cg::cluster_group cluster = cg::this_cluster();
  // the CTAs that share a (lane, kv head) and this one's share: a
  // cluster's ranks, or the ns splits
  const int c = MODE == PARTIALS ? ns : (int)cluster.num_blocks();
  const int rank = MODE == PARTIALS ? (int)(blockIdx.x % ns)
                                    : (int)cluster.block_rank();
  const int bh = blockIdx.x / c;
  const int b = bh / Hkv;
  const int hk = bh - b * Hkv;
  const int G = H / Hkv;
  const int r0 = blockIdx.y * ROWS;            // the CTA's first query row
  const int rows = min(ROWS, G - r0);
  const size_t qoff = ((size_t)b * H + hk * G + r0) * d;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kg = WIDE ? warp / NS : warp;      // the warp's key group
  const int slice = WIDE ? warp % NS : 0;     // and its columns c0 ..
  const int c0 = slice * SW;

  // the rank's share of the lane's live tiles, and the pages they touch
  const int len = min(max(kv_len[b], 0), nblk * psz);
  const int n_all = (len + BN - 1) / BN;
  const int per = (n_all + c - 1) / c;
  const int t_lo = min(rank * per, n_all);
  const int t_hi = min(n_all, t_lo + per);
  const int n_tiles = t_hi - t_lo;
  const int p_lo = t_lo * BN / psz;
  const int p_hi = n_tiles ? (min(t_hi * BN, len) + psz - 1) / psz : p_lo;

  if constexpr (MODE != DENSE) {
    for (int i = tid; i < p_hi - p_lo; i += THREADS)
      tbl[i] = table[(size_t)b * nblk + p_lo + i];
  }
  // the Q slab: rows past the group are zeros, never stored
  for (int i = tid; i < ROWS * CH; i += THREADS) {
    const int r = i / CH;
    const int cc = i - r * CH;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (PAD) {
      __nv_bfloat16* e8 = reinterpret_cast<__nv_bfloat16*>(&v);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (r < rows && cc * 8 + e < d) e8[e] = q[qoff + (size_t)r * d + cc * 8 + e];
    } else {
      if (r < rows) v = *reinterpret_cast<const uint4*>(q + qoff + (size_t)r * D + cc * 8);
    }
    *reinterpret_cast<uint4*>(qs + r * ROW + cc * 8) = v;
  }
  __syncthreads();

  // pool row of key `key` (a key of the rank's share)
  auto pool_row = [&](int key) -> size_t {
    if constexpr (MODE == DENSE) {
      return (size_t)bh * psz + key;   // (b * Hkv + hk) * S + key
    } else {
      const int p = key / psz;
      return ((size_t)tbl[p - p_lo] * Hkv + hk) * psz + (key - p * psz);
    }
  };
  uint32_t qf[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
    ldsm4(smem_addr(qs + (lane & 15) * ROW + c0 + kk * 16 + (lane >> 4) * 8),
          qf[kk]);

  const int g = lane >> 2;           // the thread's rows g, g + 8
  const int t4 = lane & 3;           // and columns 2 * t4, + 1 of each tile
  const int kb = kg * KN;            // the warp's keys kb .. kb + KN - 1
  float* scw = sc + slice * (NSTG * 2 * BN);   // the slice's copy of the scales
  float m[2] = {kNegInf, kNegInf};   // running max, log2 domain
  float l[2] = {0.f, 0.f};           // this thread's share of the row sums
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;

  // the warp's KN keys of tile t into ring stage `stage`, 16 bytes a copy,
  // keys past kv_len zero-filled (and their scales 0)
  auto load = [&](int t, int stage) {
    const int k0 = t * BN + kb;
    unsigned char* kd = smem + (size_t)(2 * stage) * L::stage_bytes + kb * KV_ROW;
    unsigned char* vd = kd + L::stage_bytes;
    for (int e = lane; e < KN * CPS; e += 32) {
      const int j = e / CPS;
      const int cc = e - j * CPS + slice * CPS;
      const int key = k0 + j;
      const bool in = key < len;
      if constexpr (PAD) {
        const size_t row = in ? pool_row(key) * d : 0;
        constexpr int ES = (int)sizeof(S);
        cp_async16_part(kd + j * KV_ROW + cc * 16, kp + row, cc, d * ES, in, kp);
        cp_async16_part(vd + j * KV_ROW + cc * 16, vp + row, cc, d * ES, in, vp);
      } else {
        const size_t off = in ? pool_row(key) * D + cc * (16 / (int)sizeof(S)) : 0;
        cp_async16(smem_addr(kd + j * KV_ROW + cc * 16), kp + off, in ? 16 : 0);
        cp_async16(smem_addr(vd + j * KV_ROW + cc * 16), vp + off, in ? 16 : 0);
      }
    }
    if constexpr (QUANT) {
      if (lane < KN) {
        const int key = k0 + lane;
        const bool in = key < len;
        const size_t row = in ? pool_row(key) : 0;
        cp_async4(smem_addr(scw + (2 * stage) * BN + kb + lane), ksc + row,
                  in ? 4 : 0);
        cp_async4(smem_addr(scw + (2 * stage + 1) * BN + kb + lane),
                  vsc + row, in ? 4 : 0);
      }
    }
  };
#pragma unroll
  for (int s = 0; s < NSTG - 1; ++s) {
    if (s < n_tiles) load(t_lo + s, s);
    cp_async_commit();
  }

  // a warp reads only the rows (of a wide instance: the columns of its
  // rows) it copied itself: the walk waits on the warp's own copy groups,
  // never on a block-wide barrier
  for (int i = 0; i < n_tiles; ++i) {
    const int t = t_lo + i;
    const int stage = i % NSTG;
    const int k0 = t * BN;
    const int kw = k0 + kb;            // the warp's first key
    cp_async_wait<NSTG - 2>();
    __syncwarp();      // the warp's rows of tile t have landed
    // tile t + NSTG - 1 into the stage of tile t - 1, which the warp is
    // done with
    if (i + NSTG - 1 < n_tiles) load(t + NSTG - 1, (i + NSTG - 1) % NSTG);
    cp_async_commit();
    const __nv_bfloat16* kt;
    const __nv_bfloat16* vt;
    const unsigned char* kr = smem + (size_t)(2 * stage) * L::stage_bytes;
    const unsigned char* vr = kr + L::stage_bytes;
    const float* k_sc = scw + (2 * stage) * BN;
    const float* v_sc = k_sc + BN;
    if constexpr (QUANT) {
      __nv_bfloat16* kw8 = reinterpret_cast<__nv_bfloat16*>(smem + L::kw_off);
      __nv_bfloat16* vw8 = reinterpret_cast<__nv_bfloat16*>(smem + L::vw_off);
#pragma unroll
      for (int e = lane; e < KN * CHS; e += 32) {
        const int j = kb + e / CHS;
        const int cc = e % CHS + slice * CHS;
        widen8(reinterpret_cast<const int8_t*>(kr + j * KV_ROW + cc * 8), kw8 + j * ROW + cc * 8);
        widen8(reinterpret_cast<const int8_t*>(vr + j * KV_ROW + cc * 8), vw8 + j * ROW + cc * 8);
      }
      __syncwarp();
      kt = kw8;
      vt = vw8;
    } else {
      kt = reinterpret_cast<const __nv_bfloat16*>(kr);
      vt = reinterpret_cast<const __nv_bfloat16*>(vr);
    }

    // S = Q K^T for the slab's 16 rows and the warp's KN keys
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bk[4];
        const int key = kb + np * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int col = c0 + kk * 16 + (((lane >> 3) & 1) << 3);
        ldsm4(smem_addr(kt + key * ROW + col), bk);
        mma16816(s[2 * np], qf[kk], bk[0], bk[1]);
        mma16816(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }
    // the wide instances: the group's slices' partials summed in slice
    // order, in the buffer of this step's parity
    if constexpr (WIDE)
      sum_slices<NS, NT>(s, reinterpret_cast<float*>(smem + L::sp_off) +
                                ((i & 1) * NWARPS + kg) * NS * NT * 128,
                         slice, lane, 1 + kg);

    // scale (and key scales), mask past kv_len, online softmax in fp32
    const bool need_mask = kw + KN > len;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = n * 8 + 2 * t4 + (e & 1);
        float x = s[n][e];
        if constexpr (QUANT) x *= k_sc[kb + j];
        x *= scale_log2;
        if (need_mask && kw + j >= len) x = kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
      // a row that has seen no key yet keeps m = -1e30 and subtracts 0,
      // so its masked keys weigh exp2(-1e30) = 0, not 1
      const float m_use = mx[r] == kNegInf ? 0.f : mx[r];
      const float alpha = exp2f(m[r] - m_use);
      m[r] = mx[r];
      mx[r] = m_use;
      l[r] *= alpha;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[dt][2 * r] *= alpha;
        acc[dt][2 * r + 1] *= alpha;
      }
    }

    // P in bf16 as the A operand of P.V (value scales folded in first)
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float p0 = exp2f(s[n][0] - mx[0]);
      float p1 = exp2f(s[n][1] - mx[0]);
      float p2 = exp2f(s[n][2] - mx[1]);
      float p3 = exp2f(s[n][3] - mx[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      if constexpr (QUANT) {
        const float v0 = v_sc[kb + n * 8 + 2 * t4];
        const float v1 = v_sc[kb + n * 8 + 2 * t4 + 1];
        p0 *= v0;
        p1 *= v1;
        p2 *= v0;
        p3 *= v1;
      }
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
      for (int dp = 0; dp < SW / 16; ++dp) {
        uint32_t bv[4];
        const int key = kb + kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        const int col = c0 + dp * 16 + ((lane >> 4) << 3);
        ldsm4_trans(smem_addr(vt + key * ROW + col), bv);
        mma16816(acc[2 * dp], pa[kk], bv[0], bv[1]);
        mma16816(acc[2 * dp + 1], pa[kk], bv[2], bv[3]);
      }
    }
  }

  cp_async_wait<0>();
  // every warp's state, plain rows: m[ROWS], l[ROWS], acc[ROWS][SROW]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
  float* st = reinterpret_cast<float*>(smem);
  __syncthreads();   // every warp is done with the tiles (the space is reused)
  {
    float* mine = st + kg * L::STATE;   // the key group's state
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = g + 8 * r;
      if (t4 == 0 && (!WIDE || slice == 0)) {
        mine[row] = m[r];
        mine[ROWS + row] = l[r];
      }
      float* ar = mine + 2 * ROWS + row * SROW + c0 + 2 * t4;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<float2*>(ar + dt * 8) =
            make_float2(acc[dt][2 * r], acc[dt][2 * r + 1]);
    }
  }
  __syncthreads();

  // the CTA's state: the warps' merged by a max-shift, 4 columns a thread
  constexpr int C4 = D / 4;
  float* cst = st + NWARPS * L::STATE;
  for (int e = tid; e < rows * C4; e += THREADS) {
    const int row = e / C4;
    const int col = (e - row * C4) * 4;
    float m_star = kNegInf;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) m_star = fmaxf(m_star, st[w * L::STATE + row]);
    float l_star = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float* ws = st + w * L::STATE;
      const float f = exp2f(ws[row] - m_star);
      l_star += ws[ROWS + row] * f;
      const float4 v = *reinterpret_cast<const float4*>(ws + 2 * ROWS + row * SROW + col);
      a.x += v.x * f;
      a.y += v.y * f;
      a.z += v.z * f;
      a.w += v.w * f;
    }
    if constexpr (MODE == PARTIALS) {
      // the split's state of query row r0 + row: (B, Hkv, ns, G) rows
      const size_t prow = (size_t)blockIdx.x * G + r0 + row;
      if constexpr (PAD) {
        if (col < d) st_part4(pacc + prow * d + col, a, d - col);
      } else {
        *reinterpret_cast<float4*>(pacc + prow * D + col) = a;
      }
      if (col == 0) {
        pm[prow] = m_star == kNegInf ? kNegInf : m_star * kLn2;
        pl[prow] = l_star;
      }
    } else {
      *reinterpret_cast<float4*>(cst + 2 * ROWS + row * SROW + col) = a;
      if (col == 0) {
        cst[row] = m_star;
        cst[ROWS + row] = l_star;
      }
    }
  }
  if constexpr (MODE == PARTIALS) {
    // K5c: with the arrival counters, the last of the ns splits of this
    // (lane, kv head, slab) to finish merges their partials into o
    if (cnt != nullptr)
      merge_splits_if_last<D, THREADS, ROWS, PAD>(
          cnt + (size_t)bh * gridDim.y + blockIdx.y, ns, rows, pm, pl, pacc,
          (size_t)G, [&](int r) { return (size_t)bh * ns * G + r0 + r; },
          [&](int r) { return o + qoff + (size_t)r * d; }, st, d);
    return;
  }
  cluster.sync();    // every rank's state is in its shared memory

  // each rank's weight per row, e^(m_k - m*) / l*, through distributed
  // shared memory (an empty lane: m* = -1e30, l* = 0 and acc = 0: o = 0)
  float* wts = cst + L::STATE;       // [MAX_CLUSTER][ROWS]
  if (tid < rows) {
    float mk[MAX_CLUSTER], lk[MAX_CLUSTER];
    float m_star = kNegInf;
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) {
      if (k < c) {
        const float* ps = cluster.map_shared_rank(cst, k);
        mk[k] = ps[tid];
        lk[k] = ps[ROWS + tid];
        m_star = fmaxf(m_star, mk[k]);
      }
    }
    float l_star = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) {
      if (k < c) {
        mk[k] = exp2f(mk[k] - m_star);
        l_star += lk[k] * mk[k];
      }
    }
    const float inv = 1.f / (l_star == 0.f ? 1.f : l_star);
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k)
      if (k < c) wts[k * ROWS + tid] = mk[k] * inv;
  }
  __syncthreads();

  // rank r stores the 4-column chunks r * THREADS + tid, + c * THREADS,
  // ... of the G x D outputs
  for (int e = rank * THREADS + tid; e < rows * C4; e += c * THREADS) {
    const int row = e / C4;
    const int col = (e - row * C4) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < MAX_CLUSTER; ++k) {
      if (k < c) {
        const float w = wts[k * ROWS + row];
        const float4 v = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(cst, k) + 2 * ROWS + row * SROW + col);
        a.x += v.x * w;
        a.y += v.y * w;
        a.z += v.z * w;
        a.w += v.w * w;
      }
    }
    if constexpr (PAD) {
      if (col < d) st_bf16_part4(o + qoff + (size_t)row * d + col, a, d - col);
    } else {
      uint2 out;
      out.x = pack_bf16(a.x, a.y);
      out.y = pack_bf16(a.z, a.w);
      *reinterpret_cast<uint2*>(o + qoff + (size_t)row * D + col) = out;
    }
  }
  cluster.sync();    // no CTA leaves while a peer still reads its state
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using namespace dec;

struct Args {
  const void* q;
  const void* kp;        // pools, or (DENSE) strips
  const void* vp;
  const float* ksc;      // int8 pools only
  const float* vsc;
  const int* table;      // not DENSE
  const int* kv_len;
  void* o;               // not PARTIALS
  float* pm;             // PARTIALS only
  float* pl;
  float* pacc;
  int B, H, Hkv, psz, nblk, D, cluster, ns;
  float scale;
  cudaStream_t st;
  int bn = DEFAULT_BN;   // keys per tile
  int* cnt = nullptr;    // PARTIALS with K5c's merge: arrival counters
  int dp = 0;            // the padded instance's width (0: D's own)
};

// f(Int<BN>) for the instantiated key tile bn of head dim D, else
// cudaErrorInvalidValue: 32 and 64 keys at D = 128 and 160 (the head
// dims of the paged archs the card serves; 160 is pixtral-12b's) and at D
// = 80 and 112 (K2's, the dense mode only: flash_decode hands it the tile
// DecodeBucket published whatever the head dim), 64 at the other head
// dims and at every padded instance (their builds stay one instance a
// mode).  No 128-key tile: its ring (213 KB of bf16 shared
// memory) leaves one CTA an SM, and it won in no mode of chip_smoke.py's
// tile sweep.
template <int D, bool PAD, typename F>
cudaError_t with_tile(int bn, F&& f) {
  if constexpr (D > 256) {           // a wide instance: 32 keys alone
    if (bn == WIDE_BN) return f(Int<WIDE_BN>{});
    return cudaErrorInvalidValue;
  } else {
    if (bn == DEFAULT_BN) return f(Int<DEFAULT_BN>{});
    if constexpr (!PAD && (D == 128 || D == 80 || D == 112 || D == 160)) {
      if (bn == 32) return f(Int<32>{});
    }
    return cudaErrorInvalidValue;
  }
}

// the head dims whose own instances have every mode; D = 80
// (h2o-danube-1.8b) and D = 112 (zamba2-7b's shared block), whose sliding
// windows serve from dense lanes, have their own DENSE mode (K2) only, and
// page, where a caller pages them, on the padded rungs 96 and 128
constexpr bool paged_dim(int d) { return d != 80 && d != 112; }

// f(Int<D>, pad) for the instance of head dim d in mode MODE: with dp = 0
// the head dim's own, else the padded instance of width dp (common.cuh's
// with_pad_width), which every mode has at every rung (a paged D = 80 or
// 112 runs on the rungs 96 and 128)
template <int MODE, typename F>
cudaError_t with_dim(int d, int dp, F&& f) {
  if (dp > 0)
    return with_pad_width(dp, d, [&](auto w) {
      return f(w, std::true_type{});
    });
  if constexpr (kPaddedBuild) {
    return cudaErrorInvalidValue;
  } else {
    const auto own = std::false_type{};
    switch (d) {
      case 16: return f(Int<16>{}, own);
      case 32: return f(Int<32>{}, own);
      case 64: return f(Int<64>{}, own);
      case 80:
        if constexpr (MODE == DENSE) return f(Int<80>{}, own);
        else return cudaErrorInvalidValue;
      case 112:
        if constexpr (MODE == DENSE) return f(Int<112>{}, own);
        else return cudaErrorInvalidValue;
      case 128: return f(Int<128>{}, own);
      case 160: return f(Int<160>{}, own);
      default: return cudaErrorInvalidValue;
    }
  }
}

template <typename S, int D, int MODE, int BN>
size_t smem_bytes(int nblk) {
  return Smem<S, D, BN>::tbl_off +
         (MODE == DENSE ? 0 : (size_t)nblk * sizeof(int));
}

// a launch of `kern` with clusters of c CTAs along x
cudaLaunchConfig_t cluster_config(dim3 grid, int threads, size_t smem, int c,
                                  cudaLaunchAttribute* attr,
                                  cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)c;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool cluster_ok(int c) { return c == 1 || c == 2 || c == 4 || c == 8; }

template <typename S, int D, int MODE, int BN, bool PAD>
cudaError_t launch(const Args& a) {
  if (a.B < 1 || a.Hkv < 1 || a.H < a.Hkv || a.H % a.Hkv || a.psz < 1 ||
      a.nblk < 1 || (MODE == PARTIALS ? a.ns < 1 : !cluster_ok(a.cluster)) ||
      (a.cnt != nullptr && a.o == nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<S, D, MODE, BN>(a.nblk);
  auto kern = paged_decode_tc_kernel<S, D, MODE, BN, PAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int G = a.H / a.Hkv;
  // PARTIALS: one CTA per split, in clusters of one
  const int per = MODE == PARTIALS ? a.ns : a.cluster;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      dim3(a.B * a.Hkv * per, (G + ROWS - 1) / ROWS), threads<D, BN>(),
      smem, MODE == PARTIALS ? 1 : a.cluster, &attr, a.st);
  err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const S*>(a.kp), static_cast<const S*>(a.vp), a.ksc, a.vsc,
      a.table, a.kv_len, static_cast<__nv_bfloat16*>(a.o), a.pm, a.pl,
      a.pacc, a.cnt, a.H, a.Hkv, a.psz, a.nblk, a.ns, a.scale * kLog2e, a.D);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename S, int MODE>
cudaError_t by_dim(const Args& a) {
  return with_dim<MODE>(a.D, a.dp, [&](auto w, auto pad) {
    constexpr int DD = decltype(w)::value;
    constexpr bool PAD = decltype(pad)::value;
    return with_tile<DD, PAD>(a.bn, [&](auto t) {
      return launch<S, DD, MODE, decltype(t)::value, PAD>(a);
    });
  });
}

// out[0..3] as instance_info; out[4..7] the clusters of 1, 2, 4 and 8
// CTAs the card co-schedules (cudaOccupancyMaxActiveClusters)
template <typename S, int D, int MODE, int BN, bool PAD>
cudaError_t info(int nblk, int* out) {
  auto kern = paged_decode_tc_kernel<S, D, MODE, BN, PAD>;
  const size_t smem = smem_bytes<S, D, MODE, BN>(nblk);
  cudaError_t err = instance_info(kern, threads<D, BN>(), smem, out);
  for (int i = 0; i < 4 && err == cudaSuccess; ++i) {
    const int c = 1 << i;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(
        dim3(c * 16), threads<D, BN>(), smem, c, &attr, nullptr);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    out[4 + i] = n;
  }
  return err;
}

template <int D, int BN, bool PAD>
cudaError_t info_by_kind(int kind, int nblk, int* out) {
  if constexpr (!PAD && !paged_dim(D)) {
    if (kind != 2) return cudaErrorInvalidValue;
    return info<__nv_bfloat16, D, DENSE, BN, PAD>(nblk, out);
  } else {
    switch (kind) {
      case 0: return info<__nv_bfloat16, D, PAGED, BN, PAD>(nblk, out);
      case 1: return info<int8_t, D, PAGED, BN, PAD>(nblk, out);
      case 2: return info<__nv_bfloat16, D, DENSE, BN, PAD>(nblk, out);
      case 3: return info<__nv_bfloat16, D, PARTIALS, BN, PAD>(nblk, out);
      case 4: return info<int8_t, D, PARTIALS, BN, PAD>(nblk, out);
      default: return cudaErrorInvalidValue;
    }
  }
}

}  // namespace

// A bf16 query and output only (float32 goes to paged_attention.cu and
// flash_attention.cu).  `cluster` is c, the CTAs per (lane, kv head): 1,
// 2, 4 or 8.  `block_k` is the key tile, keys per ring stage: 64, or at
// D = 128 and 160 (and in the dense mode at D = 80 and 112) also 32 (any
// other value: cudaErrorInvalidValue, nothing launched).  dp: 0 for the
// head dim D's own instance, else the width of the padded instance to run
// (kernels/flash_attention.py's route()), whose one key tile is 64.  Each entry point returns the launch's cudaError_t (0 =
// success).  The caller validates shapes, contiguity, alignment and that
// every table entry below ceil(kv_len / psz) names a page of the pools,
// and allocates o or the partials; the kernel never allocates or syncs.

// K3: bf16 pools.
extern "C" int repro_flash_paged_decode_tc(const void* q, const void* k_pool,
                                           const void* v_pool,
                                           const void* page_table,
                                           const void* kv_len, void* o, int B,
                                           int H, int Hkv, int psz, int nblk,
                                           int D, int dp, int cluster, int block_k,
                                           float scale, void* stream) {
  Args a{q, k_pool, v_pool, nullptr, nullptr,
         static_cast<const int*>(page_table),
         static_cast<const int*>(kv_len), o, nullptr, nullptr, nullptr,
         B, H, Hkv, psz, nblk, D, cluster, 1, scale,
         static_cast<cudaStream_t>(stream)};
  a.dp = dp;
  a.bn = block_k;
  return by_dim<__nv_bfloat16, PAGED>(a);
}

// K6a: int8 pools with scales (P, Hkv, psz).
extern "C" int repro_flash_paged_decode_quant_tc(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* kv_len, void* o, int B, int H, int Hkv, int psz, int nblk,
    int D, int dp, int cluster, int block_k, float scale, void* stream) {
  Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
         static_cast<const float*>(v_scale),
         static_cast<const int*>(page_table),
         static_cast<const int*>(kv_len), o, nullptr, nullptr, nullptr,
         B, H, Hkv, psz, nblk, D, cluster, 1, scale,
         static_cast<cudaStream_t>(stream)};
  a.dp = dp;
  a.bn = block_k;
  return by_dim<int8_t, PAGED>(a);
}

// K2: dense bf16 strips k, v (B, Hkv, S, D); kv_len clamped to [0, S].
extern "C" int repro_flash_decode_tc(const void* q, const void* k,
                                     const void* v, const void* kv_len,
                                     void* o, int B, int H, int Hkv, int S,
                                     int D, int dp, int cluster, int block_k,
                                     float scale, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr,
         static_cast<const int*>(kv_len), o, nullptr, nullptr, nullptr,
         B, H, Hkv, S, 1, D, cluster, 1, scale,
         static_cast<cudaStream_t>(stream)};
  a.dp = dp;
  a.bn = block_k;
  return by_dim<__nv_bfloat16, DENSE>(a);
}

// K5a: bf16 pools, ns splits, partials m, l (B, Hkv, ns, G) and acc (..,
// D) fp32 (m in natural-log units), merged by K5c.
extern "C" int repro_paged_decode_split_tc(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* kv_len, void* m, void* l, void* acc,
    int B, int H, int Hkv, int psz, int nblk, int ns, int D, int dp, int block_k,
    float scale, void* stream) {
  Args a{q, k_pool, v_pool, nullptr, nullptr,
         static_cast<const int*>(page_table),
         static_cast<const int*>(kv_len), nullptr,
         static_cast<float*>(m), static_cast<float*>(l),
         static_cast<float*>(acc), B, H, Hkv, psz, nblk, D, 1, ns, scale,
         static_cast<cudaStream_t>(stream)};
  a.dp = dp;
  a.bn = block_k;
  return by_dim<__nv_bfloat16, PARTIALS>(a);
}

// K6b: int8 pools with scales (P, Hkv, psz), ns splits, partials as K5a.
extern "C" int repro_paged_decode_split_quant_tc(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* kv_len, void* m, void* l, void* acc, int B, int H, int Hkv,
    int psz, int nblk, int ns, int D, int dp, int block_k, float scale,
    void* stream) {
  Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
         static_cast<const float*>(v_scale),
         static_cast<const int*>(page_table),
         static_cast<const int*>(kv_len), nullptr,
         static_cast<float*>(m), static_cast<float*>(l),
         static_cast<float*>(acc), B, H, Hkv, psz, nblk, D, 1, ns, scale,
         static_cast<cudaStream_t>(stream)};
  a.dp = dp;
  a.bn = block_k;
  return by_dim<int8_t, PARTIALS>(a);
}

// K5a with K5c's merge in its epilogue: as repro_paged_decode_split_tc, and
// the last split of each (lane, kv head, 16-row slab) to finish writes o
// (B, H, 1, D) bf16.  counters: B * Hkv * ceil(G / 16) int32, all zero on
// entry, all zero again when the launch has run; one set per stream.
extern "C" int repro_paged_decode_split_merged_tc(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* kv_len, void* m, void* l, void* acc,
    void* o, void* counters, int B, int H, int Hkv, int psz, int nblk,
    int ns, int D, int dp, int block_k, float scale, void* stream) {
  Args a{q, k_pool, v_pool, nullptr, nullptr,
         static_cast<const int*>(page_table), static_cast<const int*>(kv_len),
         o, static_cast<float*>(m), static_cast<float*>(l),
         static_cast<float*>(acc), B, H, Hkv, psz, nblk, D, 1, ns, scale,
         static_cast<cudaStream_t>(stream)};
  a.dp = dp;
  a.bn = block_k;
  a.cnt = static_cast<int*>(counters);
  if (a.cnt == nullptr) return cudaErrorInvalidValue;
  return by_dim<__nv_bfloat16, PARTIALS>(a);
}

// K6b with K5c's merge in its epilogue: int8 pools with scales, the rest
// as repro_paged_decode_split_merged_tc.
extern "C" int repro_paged_decode_split_quant_merged_tc(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* kv_len, void* m, void* l, void* acc, void* o, void* counters,
    int B, int H, int Hkv, int psz, int nblk, int ns, int D, int dp, int block_k,
    float scale, void* stream) {
  Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
         static_cast<const float*>(v_scale),
         static_cast<const int*>(page_table), static_cast<const int*>(kv_len),
         o, static_cast<float*>(m), static_cast<float*>(l),
         static_cast<float*>(acc), B, H, Hkv, psz, nblk, D, 1, ns, scale,
         static_cast<cudaStream_t>(stream)};
  a.dp = dp;
  a.bn = block_k;
  a.cnt = static_cast<int*>(counters);
  if (a.cnt == nullptr) return cudaErrorInvalidValue;
  return by_dim<int8_t, PARTIALS>(a);
}

// The instance for head dim D and key tile block_k of kind 0 (K3: bf16
// pools), 1 (K6a: int8 pools), 2 (K2: bf16 strips), 3 (K5a: bf16 pools,
// partials) or 4 (K6b: int8 pools, partials): out[0..7]
// = registers per thread, local-memory (spill) bytes, dynamic shared
// memory in bytes at nblk table entries (K2: none), resident CTAs per SM,
// and the clusters of 1, 2, 4 and 8 CTAs the card holds at once.
extern "C" int repro_paged_decode_tc_info(int D, int dp, int kind, int nblk,
                                          int block_k, int* out) {
  return with_dim<DENSE>(D, dp, [&](auto w, auto pad) {
    constexpr int DD = decltype(w)::value;
    constexpr bool PAD = decltype(pad)::value;
    return with_tile<DD, PAD>(block_k, [&](auto t) {
      return info_by_kind<DD, decltype(t)::value, PAD>(kind, nblk, out);
    });
  });
}
