// Paged chunked prefill on Hopper's tensor cores (sm_90a): the attention
// of a prefill or verify chunk with a bf16 query, in one pass against bf16
// K/V page pools (P, Hkv, psz, D) or int8 pools with per-row fp32 scales
// (P, Hkv, psz), or as the split partials (num_splits > 1) against either;
// each sequence reaches its pages through a row of a page table
// (B, nblk) int32.  Plain C interface, bound from Python with ctypes
// (kernels/paged_attention.py); no PyTorch headers.
//
// Replaces the Pallas kernels of src/repro/kernels/flash_attention.py:
// K4  paged_prefill_tc_kernel<bf16, one pass>  flash_paged_prefill (:668) /
//                                    _paged_prefill_kernel (pallas_call :733)
// K6c paged_prefill_tc_kernel<int8, one pass>  flash_paged_prefill_quant
//                                    (:1126) / _paged_prefill_quant_kernel (:1186)
// K5b paged_prefill_tc_kernel<bf16, partials>  _paged_prefill_split_kernel
//                                    (pallas_call :779, body :607)
// K6d paged_prefill_tc_kernel<int8, partials>  _paged_prefill_split_quant_
//                                    kernel (pallas_call :1239)
// K5c, in the partials epilogue of the merged entries: _combine_splits
//                                    (:304) / _split_combine_kernel (:315)
// A float32 query keeps paged_attention.cu's SIMT template (a TF32 product
// would break the fp32 tolerance); the wrapper picks by the query's type.
//
// Semantics of the TPU kernels: query row i of sequence b sits at absolute
// position start[b] + i; key j is visible iff j <= start[b] + i and
// j < kv_len[b]; masked scores are -1e30; the softmax statistics are fp32;
// a row with no key gives exactly 0; GQA maps query head h to kv head
// h / (H / Hkv); table entries past ceil(kv_len / psz) are never read.
// Rounding: Q.K^T and P.V are bf16 products summed in fp32 (int8 codes are
// exact in bf16); for int8 pools the key scale multiplies column j of S in
// fp32 after the product, S_ij = k_scale_j * sum_d q_id code_jd, and the
// value scale is folded into P before P is rounded to bf16,
// sum_j bf16(p_ij * v_scale_j) * code_j.  So the one rounding the plain
// fp32 version does not make is P (or P * v_scale) to bf16: each term
// moves by at most 2^-8 (bf16's unit roundoff), an output by at most 2^-8
// of max |v|; the row sums l are taken from the fp32 P.
//
// What bounds it on an H100.  At the main path's shape (a yi-6b chunk of
// 128 rows at start 384, kv_len 512: H 32, Hkv 4, D 128, psz 16, bf16):
// bytes 0.00094 ms (q in, o out, the K/V prefix once, at 3.35 TB/s),
// operations 0.00095 ms (4 flops per visible (query, key) pair and column
// at 989 TFLOP/s).  Both under a microsecond, so what the kernel pays is
// latency: of the launch, of the dependent kv_len, page-table and K/V
// loads, and of the serial walk over key tiles.  The SIMT template it
// replaces ran at ~420x that bound for four reasons; the design answers
// each:
//  1. no tensor cores -> QK^T and P.V are mma.sync.m16n8k16 bf16 with fp32
//     accumulators, each warp on one 16-row slab, fed by ldmatrix (.trans
//     for V) from shared rows padded by 16 bytes (conflict-free); S and
//     the online softmax stay in fp32 registers (row max by quad
//     shuffles), P is packed to bf16 in registers as the A operand of P.V
//     (as FlashAttention-2 does); Q's fragments are loaded once a block;
//  2. no overlap of loads and math -> K/V tiles of 128 keys arrive by
//     16-byte cp.async copies, each row addressed through the page table
//     staged in shared memory once per block, into a ring of 2 stages:
//     tile t + 1's copies are in flight while tile t is multiplied, with
//     one __syncthreads per tile (two for int8, whose codes arrive as
//     int8, half the bytes of bf16, and are widened to bf16 in shared
//     memory once per tile on the full-rate ALUs).  cp.async, not TMA: a
//     page of one kv head is a psz x D run, a tile several such runs at
//     table-chosen addresses, and per-row copies zero-fill the keys past
//     kv_len for free;
//  3. K/V read once per query head -> GQA folded into the query tile: one
//     block per (sequence, kv head, tile of 32 / G chunk rows), the G
//     query heads of the kv head stacked into the tile's 32 rows (row r is
//     chunk row r / G of head r % G), so each K/V tile is loaded once for
//     all G heads (8 for yi-6b; deepseek-7b's G = 1 stacks 32 chunk rows);
//     the causal skip of a key tile uses the tile's last chunk row;
//  4. little latency hiding -> 32-row query tiles, twice the blocks of
//     64-row ones (at the phase-8 shape 128 blocks on 132 SMs, where 64-row
//     tiles would leave 68 idle), and 8 warps a block, the tile's 2 slabs
//     times 4 key groups: each warp takes a quarter of every key tile, so
//     a warp's serial chain of mma, shuffles and exp2 is that much
//     shorter, and the groups' (m, l, acc) states merge once at the end by
//     a max-shift through shared memory.
// K5b, the partials mode (SPLIT): for grids far below the SM count (the
// verify shape, chunks of 5 rows over 4 lanes, has 40 blocks) the key walk
// of each query tile is cut into ns splits, one block each along
// blockIdx.x = tile * ns + split.  Split s walks the tiles [s * per,
// min((s + 1) * per, t_live)) of the tile's t_live live key tiles, per =
// ceil(t_live / ns), which is ref.paged_prefill_split_ref's partition at
// block_q = BM / G chunk rows and block_k = BN keys; trailing splits may
// get none.  Instead of acc / l it writes the merged key groups'
// unnormalised (m, l, acc) in fp32 for the chunk's rows (row r of the
// folded tile is chunk row r / G of head hk * G + r % G; padding rows are
// never written), m converted from the log2 domain to natural units,
// which K5c's expf takes; a row that saw no key of its split writes
// exactly (-1e30, 0, 0).  At the verify shape with 8 splits: 320 blocks,
// each walking at most one 128-key tile.
// K6d is the same partials mode over int8 pools: K6c's widening and scales
// (the key scale on S's column after the code product, the value scale
// folded into P before P is packed to bf16, l from the fp32 P), so acc is
// K5b's sum over the dequantized values, within 2^-8 sum_j p_j |v_j| of
// the fp32 one.  It adds nothing to K6c's shared memory (the partials are
// stored from registers).
// K5c in the epilogue (the merged entries, given arrival counters): the
// partials are stored as above, then the ns blocks of a (lane, kv head, q
// tile) count their arrivals on one int32 counter, and the last to arrive
// merges the tile's rows from L2 as K5c does (common.cuh's
// merge_splits_if_last, bit-equal to split_combine_kernel over the same
// partials) and resets the counter; no block waits on another.  A split
// verify is then one launch instead of two.
// The tile is a pair of template parameters, the run-time AT's block_q x G
// query rows and block_k keys (tuning/dynamic.py's PrefillBucket and
// SpecBucket regions): 32 rows and 128 keys by default, the design above;
// at D = 128 also rows 16, 48, 64 and 80 and keys 64 (see Tile), at D =
// 160 (pixtral-12b, G 4) rows 16 and 64 and keys 64.  The tile
// sets the grid (query tiles x splits), the key groups whose online
// softmax states merge at the end, and the split partition.  G need not be
// a power of two: the 48-row tile holds 16 chunk rows of phi4-mini's G = 3
// heads and the 80-row tile 16 of llama4-scout's G = 5, the fold's row r
// being chunk row r / G of head r % G.
// Any G: the padded instances (below) flatten the rows.  A kv head's
// chunk is C x G (position, head) rows, row f being chunk row f / G of
// head f % G, and tile t holds its rows t * BM .. t * BM + BM - 1, so K/V
// is still read once a tile for every head the tile holds.  Where G
// divides BM that is the fold above, the same rows, tiles and launches bit
// for bit; where it does not (G 7 of Qwen2-7B's 28 heads over 4, G 3 or 5
// at D = 160, G above 80) a tile spans no whole number of positions, each
// row takes the causal mask of its own position, the tile's live key
// tiles are those its last row sees, and the rows past C x G in the last
// tile are masked and never stored.  Such a G runs on the padded instance
// of the smallest rung at or above its head dim (kernels/
// paged_attention.py's prefill_route: at D = 128 the rung 128), whose
// arithmetic at d = DP is the own instance's.
// Head dims: the instances of their own at D = 16, 32, 64, 128 and 160,
// and the padded ones (PAD, common.cuh) at the rungs 64, 96, 128, 160, 192
// and 256, each with one tile: 32 rows by 128 keys, 64 keys at 256 (a
// 128-key ring of 528-byte rows would not fit); above 256 the wide rungs
// 384 and 512 (32 rows by 32 keys, the head dim split across warps: Tile's
// notes below, common.cuh).  A padded row of d
// elements that is not a multiple of 16 bytes arrives by 4-byte copies
// (d * sizeof(S) % 4 == 0) or plain loads; the pools keep d elements a
// row.
// Left for later: wgmma and TMA.

#include "mma.cuh"

namespace {

namespace tc {
constexpr int STAGES = 2;         // ring of K/V tiles in flight
constexpr int DEFAULT_SLABS = 2;  // the tile of an untuned launch: 32 rows
constexpr int DEFAULT_BN = 128;   // and 128 keys

// The tile, template parameters of the kernel (the run-time AT's block_q
// x G and block_k): BM = 16 SLABS query rows and BN keys per K/V tile.
// The warps of a block: SLABS 16-row mma slabs times KGROUPS key groups,
// group kg taking keys kg * KN .. kg * KN + KN - 1 of every K/V tile; 4
// groups up to 2 slabs (128 or 256 threads), 2 from 3 slabs (192, 256 or
// 320), so that a block stays at most 10 warps and a thread's registers
// (its slab's acc, 64 fp32 at D = 128) stay under the 255 that 256
// threads may hold (3 slabs by 4 groups would be 384 threads, 170
// registers each).
// BOUND is the launch bound's thread count: THREADS, but 256 for 3 slabs,
// whose 6-warp block ptxas otherwise squeezes under the 170 registers of
// two blocks an SM at the cost of a spill (bf16 partials at 64 keys: 168
// registers, 4 bytes); with the 8-warp bound of 4 slabs it keeps every
// register it needs and runs one block an SM, as the 4-slab tile does.
// The 5-slab tile (80 rows: llama4-scout's 16 chunk rows at G 5) has 10
// warps, 320 threads, its bound its own thread count.  The card allocates
// registers to a block's warps in groups of 4, so 10 warps hold what 12
// would: 168 registers a thread (65,536 / 384, rounded down to 8), where
// the 8-warp tiles take 208-210 at 128 keys.  A warp of the 5-slab tile
// therefore walks its 64 keys of a 128-key tile in four 16-key softmax
// steps (KS), in a loop kept rolled so that the steps reuse one set of
// registers: 152-168 registers and no spill, where one 64-key step
// spilled 4-84 bytes and 32-key steps 12 (the int8 partials instance).
// At 64 keys (one 32-key step a warp) the tile keeps its 167-168
// registers without a spill.
template <int SLABS_, int BN_>
struct Tile {
  static constexpr int SLABS = SLABS_;
  static constexpr int BN = BN_;
  static constexpr int BM = 16 * SLABS;
  static constexpr int KGROUPS = SLABS >= 3 ? 2 : 4;
  static constexpr int NWARPS = SLABS * KGROUPS;
  static constexpr int THREADS = NWARPS * 32;
  static constexpr int BOUND = SLABS == 3 ? 256 : THREADS;
  static constexpr int KN = BN / KGROUPS;
  // keys of one online-softmax step of a warp: its KN keys of the tile at
  // once, but 16 for the 10-warp 5-slab tile at 128 keys, which holds 168
  // registers a thread (see above) where a 64-key step needs ~210
  static constexpr int KS = SLABS == 5 && KN > 32 ? 16 : KN;
};

// The blocks an SM the launch bound asks for: none (0) up to D = 128,
// where ptxas's own choice keeps every register the body needs; one at D
// = 160, whose 4-warp partials tile of 16 rows by 64 keys ptxas would
// otherwise squeeze under the 168 registers of three blocks an SM at the
// cost of a 20-byte spill (asked for one, it takes 189 and spills
// nothing; the D <= 128 instances build exactly as before).
template <int D>
constexpr int min_blocks() { return D > 128 ? 1 : 0; }

// The wide instances (D > 256, common.cuh): one tile, 32 rows by 32 keys,
// one key group, each of the 2 slabs served by head_slices<D>() warps (8
// at D = 512, 6 at 384), one per 128 columns; the block copies and widens
// whole rows as before, each warp multiplies its own columns, and the
// slab's partial S meet in shared memory (one step a tile: the next
// tile's block barrier frees them).  Shared memory before the table at D
// = 512: 182,784 B over bf16 pools, 184,320 over int8 (137,728 and
// 139,136 at 384), one block an SM; a thread holds 32 Q fragment registers
// and 64 fp32 of O (ptxas: 183-201 registers in one pass, 233-248 in the
// partials mode with the merge, no spill).
constexpr int WIDE_BN = 32;
template <int D, int SLABS, int BN>
__host__ __device__ constexpr int kgroups() {
  return D > 256 ? 1 : Tile<SLABS, BN>::KGROUPS;
}
template <int D, int SLABS, int BN>
__host__ __device__ constexpr int threads() {
  return D > 256 ? SLABS * head_slices<D>() * 32 : Tile<SLABS, BN>::THREADS;
}
template <int D, int SLABS, int BN>
__host__ __device__ constexpr int bound() {
  return D > 256 ? threads<D, SLABS, BN>() : Tile<SLABS, BN>::BOUND;
}

// Dynamic shared memory of one block, in bytes: the Q tile (bf16 rows of
// D + 8), the ring of K and V tiles as stored (rows of D * sizeof(S) + 16
// bytes), for int8 pools the bf16 K and V tiles the codes widen to and the
// ring's per-row scales, then the lane's live page-table entries.
template <typename S, int D, int SLABS, int BN>
struct Smem {
  static constexpr int BM = Tile<SLABS, BN>::BM;
  static constexpr int KGROUPS = kgroups<D, SLABS, BN>();
  static constexpr bool QUANT = std::is_same_v<S, int8_t>;
  static constexpr int ROW = D + 8;                               // bf16 elements
  static constexpr int KV_ROW = (int)(D * sizeof(S)) + 16;        // bytes
  static constexpr size_t q_bytes = (size_t)BM * ROW * 2;
  static constexpr size_t stage_bytes = (size_t)BN * KV_ROW;
  static constexpr size_t wide_bytes = QUANT ? (size_t)BN * ROW * 2 : 0;
  static constexpr size_t scale_bytes = QUANT ? (size_t)STAGES * BN * 4 : 0;
  static constexpr size_t k_off = q_bytes;
  static constexpr size_t v_off = k_off + STAGES * stage_bytes;
  static constexpr size_t kw_off = v_off + STAGES * stage_bytes;
  static constexpr size_t vw_off = kw_off + wide_bytes;
  static constexpr size_t ks_off = vw_off + wide_bytes;
  static constexpr size_t vs_off = ks_off + scale_bytes;
  // the wide instances' partial S of each slab's slices (sum_slices)
  static constexpr size_t sp_off = vs_off + scale_bytes;
  static constexpr size_t sp_bytes =
      D > 256 ? (size_t)SLABS * head_slices<D>() * BN * 16 * 4 : 0;
  static constexpr size_t tbl_off = sp_off + sp_bytes;
  // after the walk the ring (and the widened tiles) hold the softmax
  // states of key groups 1.., in the fragment layout: per (group, slab,
  // lane) m[2], l[2], acc[D / 8][4]
  static constexpr int MERGE = 4 + D / 2;   // floats per lane
  static constexpr size_t merge_bytes =
      (size_t)(KGROUPS - 1) * SLABS * 32 * MERGE * 4;
  static_assert(merge_bytes <= ks_off - k_off, "merge space");
};
}  // namespace tc

// ---------------------------------------------------------------------------
// K4 / K6c / K5b / K6d: q (B, H, C, D) bf16, pools (P, Hkv, psz, D) of S
// (bf16, or int8 with scales (P, Hkv, psz) fp32), table (B, nblk), start
// and kv_len (B,) int32.  SPLIT = false: o (B, H, C, D) bf16, grid
// (ceil(C / (BM / G)), Hkv, B).  SPLIT = true: blockIdx.x = q_tile * ns + split, the
// block walks its split of the tile's live key tiles and writes the
// unnormalised fp32 partials m, l (B, H, ns, C) and acc (B, H, ns, C, D),
// m in natural-log units; with cnt (B * Hkv * q tiles int32 arrival
// counters, zero on entry and left zero) also o, K5c's merge of the
// splits.  G query heads per kv head, dividing the tile's BM rows;
// scale_log2 = scale * log2(e), so the softmax runs on exp2.
// ---------------------------------------------------------------------------

template <typename S, int D, bool SPLIT, int SLABS, int BN, bool PAD>
__global__ void __launch_bounds__(tc::bound<D, SLABS, BN>(),
                                  tc::min_blocks<D>())
paged_prefill_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const S* __restrict__ kp, const S* __restrict__ vp,
                        const float* __restrict__ ksc,
                        const float* __restrict__ vsc,
                        const int* __restrict__ table,
                        const int* __restrict__ start,
                        const int* __restrict__ kv_len,
                        __nv_bfloat16* __restrict__ o, float* __restrict__ pm,
                        float* __restrict__ pl, float* __restrict__ pacc,
                        int* __restrict__ cnt, int H, int Hkv, int C, int psz,
                        int nblk, int ns, int G, float scale_log2,
                        int d_run) {
  using namespace tc;
  const int d = PAD ? d_run : D;        // the row stride (common.cuh)
  // rows narrower than the instance take the partial copies and stores; a
  // padded instance at d = D runs an own instance's full-row code (16-byte
  // copies, packed stores), which on an H100 keeps a G that divides no own
  // row tile (flattened onto the padded instance of its own width) as fast
  // as a flattened own instance would be
  const bool part = PAD && d != D;
  using T = Tile<SLABS, BN>;
  using L = Smem<S, D, SLABS, BN>;
  constexpr bool WIDE = D > 256;                // the head dim across warps
  constexpr int NS = head_slices<D>();          // column slices of a slab
  constexpr int SW = D / NS;                    // a slice's columns
  constexpr int BM = T::BM;
  constexpr int KGROUPS = L::KGROUPS;
  constexpr int KN = WIDE ? BN : T::KN;
  constexpr int THREADS = threads<D, SLABS, BN>();
  constexpr bool QUANT = L::QUANT;
  constexpr int ROW = L::ROW;
  constexpr int KV_ROW = L::KV_ROW;
  constexpr int CPR = D * (int)sizeof(S) / 16;  // 16-byte copies per K/V row
  constexpr int QCPR = D * 2 / 16;              // and per q row
  constexpr int KS = WIDE ? BN : T::KS;         // keys of a softmax step
  constexpr int NT = KS / 8;                    // 8-key column tiles of S
  constexpr int DT = SW / 8;                    // 8-wide column tiles of O
  constexpr int KT = SW / 16;                   // 16-deep steps of QK^T
  static_assert(THREADS >= BN && D % 16 == 0 && KS % 16 == 0 &&
                KN % KS == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* k_ring = smem + L::k_off;
  unsigned char* v_ring = smem + L::v_off;
  float* ks_ring = reinterpret_cast<float*>(smem + L::ks_off);
  float* vs_ring = reinterpret_cast<float*>(smem + L::vs_off);
  int* tbl = reinterpret_cast<int*>(smem + L::tbl_off);

  // PAD (the padded instances take the flattened rows): the tile is rows
  // f0 .. f0 + BM - 1 of the kv head's C x G (position, head) rows, row f
  // being chunk row f / G of head f % G; else (G divides BM) RQ chunk rows
  // from i0 of all G heads, row r being chunk row i0 + r / G of head r % G:
  // the same rows where G divides BM
  const int RQ = BM / G;                // chunk rows per tile
  const int tile = SPLIT ? blockIdx.x / ns : blockIdx.x;
  const int split = SPLIT ? blockIdx.x - tile * ns : 0;
  const int f0 = tile * BM;             // the tile's first (position, head) row
  const int i0 = PAD ? f0 / G : tile * RQ;   // and its first chunk row
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = min(max(kv_len[b], 0), nblk * psz);
  const int q_start = start[b] + i0;   // absolute position of row i0
  // live key tiles: committed and causally visible to the tile's last
  // row; a split walks tiles t_lo .. t_end - 1, ceil(live / ns) of them
  // (the partition of ref.paged_prefill_split_ref at rows = BM, block_k =
  // BN: block_q = BM / G where G divides BM), the last splits possibly none
  const int last = PAD ? start[b] + (f0 + BM - 1) / G : q_start + RQ - 1;
  const int t_live = last < 0 ? 0 : min((len + BN - 1) / BN, last / BN + 1);
  int t_lo = 0, t_end = t_live;
  if constexpr (SPLIT) {
    const int per = (t_live + ns - 1) / ns;
    t_lo = min(split * per, t_live);
    t_end = min(t_live, t_lo + per);
  }
  const int n_tiles = t_end - t_lo;
  const int n_pages = (min(len, t_end * BN) + psz - 1) / psz;

  // Q tile: row r is chunk row qi of head hk * G + hq (above); rows past
  // the chunk are zeros, never stored
  for (int i = tid; i < BM * QCPR; i += THREADS) {
    const int r = i / QCPR;
    const int c = i - r * QCPR;
    const int qi = PAD ? (f0 + r) / G : i0 + r / G;
    const int hq = PAD ? (f0 + r) % G : r % G;
    const bool in = qi < C;
    if (part) {
      cp_async16_part(qs + r * ROW + c * 8,
                      q + (((size_t)b * H + hk * G + hq) * C + qi) * d, c,
                      d * 2, in, q);
    } else {
      const __nv_bfloat16* src =
          in ? q + (((size_t)b * H + hk * G + hq) * C + qi) * D + c * 8
             : q;
      cp_async16(smem_addr(qs + r * ROW + c * 8), src, in ? 16 : 0);
    }
  }
  for (int i = tid; i < n_pages; i += THREADS) tbl[i] = table[(size_t)b * nblk + i];
  __syncthreads();

  // one key tile's rows (and scales) into ring stage `stage`; keys at or
  // past kv_len are zero-filled, so masked values are 0, never garbage
  auto load_tile = [&](int t, int stage) {
    const int k0 = t * BN;
    unsigned char* kd = k_ring + stage * L::stage_bytes;
    unsigned char* vd = v_ring + stage * L::stage_bytes;
    for (int i = tid; i < BN * CPR; i += THREADS) {
      const int j = i / CPR;
      const int c = i - j * CPR;
      const int key = k0 + j;
      const bool in = key < len;
      if (part) {
        size_t row = 0;
        if (in) {
          const int blk = key / psz;
          row = (((size_t)tbl[blk] * Hkv + hk) * psz + (key - blk * psz)) * d;
        }
        constexpr int ES = (int)sizeof(S);
        cp_async16_part(kd + j * KV_ROW + c * 16, kp + row, c, d * ES, in, kp);
        cp_async16_part(vd + j * KV_ROW + c * 16, vp + row, c, d * ES, in, vp);
      } else {
        size_t off = 0;
        if (in) {
          const int blk = key / psz;
          off = (((size_t)tbl[blk] * Hkv + hk) * psz + (key - blk * psz)) * D +
                c * (16 / (int)sizeof(S));
        }
        cp_async16(smem_addr(kd + j * KV_ROW + c * 16), kp + off, in ? 16 : 0);
        cp_async16(smem_addr(vd + j * KV_ROW + c * 16), vp + off, in ? 16 : 0);
      }
    }
    if constexpr (QUANT) {
      if (tid < BN) {
        const int key = k0 + tid;
        const bool in = key < len;
        size_t row = 0;
        if (in) {
          const int blk = key / psz;
          row = ((size_t)tbl[blk] * Hkv + hk) * psz + (key - blk * psz);
        }
        cp_async4(smem_addr(ks_ring + stage * BN + tid), ksc + row, in ? 4 : 0);
        cp_async4(smem_addr(vs_ring + stage * BN + tid), vsc + row, in ? 4 : 0);
      }
    }
  };

  // group s holds tile t_lo + s (group 0 also Q); one group is committed
  // per tile even when empty, so wait_group counts stay uniform
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(t_lo + s, s);
    cp_async_commit();
  }

  const int wq = WIDE ? warp / NS : warp;  // the warp's slab and key group
  const int slice = WIDE ? warp % NS : 0;  // and its columns c0 ..
  const int c0 = slice * SW;
  const int row0 = (wq % SLABS) * 16;   // the warp's 16-row slab
  const int kg = wq / SLABS;            // and its keys kg * KN .. + KN - 1
  const int g = lane >> 2;              // the thread's rows: row0 + g, + 8
  const int t4 = lane & 3;              // and columns 2 * t4, + 1 of each tile
  const int pos0 = PAD ? start[b] + (f0 + row0 + g) / G
                        : q_start + (row0 + g) / G;
  const int pos1 = PAD ? start[b] + (f0 + row0 + g + 8) / G
                        : q_start + (row0 + g + 8) / G;
  const int warp_pos = PAD ? start[b] + (f0 + row0) / G   // the slab's
                            : q_start + row0 / G;          // first row

  float m[2] = {kNegInf, kNegInf};      // running max, log2 domain
  float l[2] = {0.f, 0.f};              // this thread's share of the row sums
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  uint32_t qf[KT][4];

  for (int i = 0; i < n_tiles; ++i) {
    const int t = t_lo + i;
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t has landed; the stage of tile t - 1 is free
    if (i + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    const int stage = i % STAGES;

    const __nv_bfloat16* kt;
    const __nv_bfloat16* vt;
    if constexpr (QUANT) {
      // widen the codes to bf16 (exact: |code| <= 127)
      __nv_bfloat16* kw = reinterpret_cast<__nv_bfloat16*>(smem + L::kw_off);
      __nv_bfloat16* vw = reinterpret_cast<__nv_bfloat16*>(smem + L::vw_off);
      const int8_t* k8 = reinterpret_cast<const int8_t*>(k_ring + stage * L::stage_bytes);
      const int8_t* v8 = reinterpret_cast<const int8_t*>(v_ring + stage * L::stage_bytes);
      constexpr int CH = D / 8;
      for (int i = tid; i < BN * CH; i += THREADS) {
        const int j = i / CH;
        const int c = i - j * CH;
        widen8(k8 + j * KV_ROW + c * 8, kw + j * ROW + c * 8);
        widen8(v8 + j * KV_ROW + c * 8, vw + j * ROW + c * 8);
      }
      __syncthreads();
      kt = kw;
      vt = vw;
    } else {
      kt = reinterpret_cast<const __nv_bfloat16*>(k_ring + stage * L::stage_bytes);
      vt = reinterpret_cast<const __nv_bfloat16*>(v_ring + stage * L::stage_bytes);
    }

    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        ldsm4(smem_addr(qs + (row0 + (lane & 15)) * ROW + c0 + kk * 16 +
                        (lane >> 4) * 8),
              qf[kk]);
    }

    // the warp's KN keys of the tile in steps of KS keys: S = Q K^T for
    // the slab's 16 rows and the step's keys
#pragma unroll 1
    for (int st = 0; st < KN / KS; ++st) {
      const int kb = kg * KN + st * KS;     // the step's first key of the tile
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
      // the wide instances: the slab's slices' partials summed in slice
      // order
      if constexpr (WIDE)
        sum_slices<NS, NT>(s, reinterpret_cast<float*>(smem + L::sp_off) +
                                  (row0 / 16) * NS * NT * 128,
                           slice, lane, 1 + row0 / 16);

      // scale (and key scales), mask, online softmax in fp32
      const int k0 = t * BN + kb;           // the step's first key
      const bool need_mask = k0 + KS > len || k0 + KS - 1 > warp_pos;
      const float* ksc_t = ks_ring + stage * BN + kb;
      const float* vsc_t = vs_ring + stage * BN + kb;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = n * 8 + 2 * t4 + (e & 1);
          float x = s[n][e];
          if constexpr (QUANT) x *= ksc_t[j];
          x *= scale_log2;
          if (need_mask) {
            const int key = k0 + j;
            if (key >= len || key > (e < 2 ? pos0 : pos1)) x = kNegInf;
          }
          s[n][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(kFull, mx[r], 2));
        // a row that has seen no key of its group yet keeps m = -1e30 and
        // subtracts 0, so its masked keys weigh exp2(-1e30) = 0, not 1
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
          const float v0 = vsc_t[n * 8 + 2 * t4];
          const float v1 = vsc_t[n * 8 + 2 * t4 + 1];
          p0 *= v0;
          p1 *= v1;
          p2 *= v0;
          p3 *= v1;
        }
        pa[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
        pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
      }

      // O += P V
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
  }
  cp_async_wait<0>();
  __syncthreads();    // the ring is free: it takes the merge

  // merge the key groups' states by a max-shift: group 1 leaves (m, l,
  // acc) in the fragment layout, group 0 folds it into its own
  constexpr size_t GROUP = (size_t)SLABS * 32 * L::MERGE;   // floats
  float* mrg = reinterpret_cast<float*>(smem + L::k_off) +
               ((size_t)(warp % SLABS) * 32 + lane) * L::MERGE;
  if (kg > 0) {
    float* mine = mrg + (kg - 1) * GROUP;
    mine[0] = m[0];
    mine[1] = m[1];
    mine[2] = l[0];
    mine[3] = l[1];
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[4 + dt * 4 + e] = acc[dt][e];
  }
  __syncthreads();
  // key group 0 folds the other groups in and stores the rows
  if (kg == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m_star = m[r];
      for (int k = 1; k < KGROUPS; ++k) m_star = fmaxf(m_star, mrg[(k - 1) * GROUP + r]);
      const float a0 = exp2f(m[r] - m_star);
      l[r] *= a0;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        acc[dt][2 * r] *= a0;
        acc[dt][2 * r + 1] *= a0;
      }
      for (int k = 1; k < KGROUPS; ++k) {
        const float* theirs = mrg + (k - 1) * GROUP;
        const float a = exp2f(theirs[r] - m_star);
        l[r] += theirs[2 + r] * a;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          acc[dt][2 * r] += theirs[4 + dt * 4 + 2 * r] * a;
          acc[dt][2 * r + 1] += theirs[4 + dt * 4 + 2 * r + 1] * a;
        }
      }
      m[r] = m_star;
    }

    // store the chunk's rows: normalised (no key seen leaves acc = 0), or
    // the split's partials, where a row that saw no key of the split stores
    // exactly (-1e30, 0, 0) and m leaves the log2 domain
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(kFull, l[r], 1);
      l[r] += __shfl_xor_sync(kFull, l[r], 2);
      const int row = row0 + g + 8 * r;
      const int qi = PAD ? (f0 + row) / G : i0 + row / G;
      const int hr = PAD ? (f0 + row) % G : row % G;
      if (qi >= C) continue;
      if constexpr (SPLIT) {
        const size_t prow =
            (((size_t)b * H + hk * G + hr) * ns + split) * C + qi;
        if (t4 == 0 && (!WIDE || slice == 0)) {
          pm[prow] = m[r] == kNegInf ? kNegInf : m[r] * (1.f / kLog2e);
          pl[prow] = l[r];
        }
        float* dst = pacc + prow * d + c0 + 2 * t4;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          if (part) {
            const int col = c0 + dt * 8 + 2 * t4;
            if (col < d) dst[dt * 8] = acc[dt][2 * r];
            if (col + 1 < d) dst[dt * 8 + 1] = acc[dt][2 * r + 1];
          } else {
            *reinterpret_cast<float2*>(dst + dt * 8) =
                make_float2(acc[dt][2 * r], acc[dt][2 * r + 1]);
          }
        }
        continue;
      }
      const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
      __nv_bfloat16* dst =
          o + (((size_t)b * H + hk * G + hr) * C + qi) * d + c0 + 2 * t4;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        if (part) {
          const int col = c0 + dt * 8 + 2 * t4;
          if (col < d) dst[dt * 8] = __float2bfloat16(acc[dt][2 * r] * inv);
          if (col + 1 < d)
            dst[dt * 8 + 1] = __float2bfloat16(acc[dt][2 * r + 1] * inv);
        } else {
          *reinterpret_cast<uint32_t*>(dst + dt * 8) =
              pack_bf16(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
        }
      }
    }
  }
  if constexpr (SPLIT) {
    // K5c: with the arrival counters, the last of the ns splits of this
    // (lane, kv head, q tile) to finish merges their partials into o
    if (cnt != nullptr) {
      const int tiles = gridDim.x / ns;
      const size_t head0 = (size_t)b * H + hk * G;
      if constexpr (PAD) {
        merge_splits_if_last<D, THREADS, BM, PAD>(
            cnt + ((size_t)b * Hkv + hk) * tiles + tile, ns,
            min(BM, C * G - f0), pm, pl, pacc, (size_t)C,
            [&](int r) {
              return (head0 + (f0 + r) % G) * ns * C + (f0 + r) / G;
            },
            [&](int r) {
              return o + ((head0 + (f0 + r) % G) * C + (f0 + r) / G) * d;
            },
            reinterpret_cast<float*>(smem), d);
      } else {
        merge_splits_if_last<D, THREADS, BM>(
            cnt + ((size_t)b * Hkv + hk) * tiles + tile, ns,
            min(BM, (C - i0) * G), pm, pl, pacc, (size_t)C,
            [&](int r) { return (head0 + r % G) * ns * C + i0 + r / G; },
            [&](int r) { return o + ((head0 + r % G) * C + i0 + r / G) * D; },
            reinterpret_cast<float*>(smem));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

using namespace tc;

struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const float* ksc;      // int8 pools only
  const float* vsc;
  const int* table;
  const int* start;
  const int* kv_len;
  void* o;               // normalised output (one pass)
  float* pm;             // partials (split)
  float* pl;
  float* pacc;
  int B, H, Hkv, C, psz, nblk, ns, D;
  float scale;
  cudaStream_t st;
  int rows = 0;          // query rows per tile (0: the default, 32)
  int bn = DEFAULT_BN;   // keys per K/V tile
  int* cnt = nullptr;    // split with K5c's merge: arrival counters
  int dp = 0;            // the padded instance's width (0: D's own)
};

// The key tile of a padded instance: 128, but 64 at D = 256, whose 128-key
// ring (four stages of 128 rows of 528 bytes, 270,336 B) would not fit the
// 227 KB a block may hold, and 32 at the wide instances (D > 256)
template <int D>
constexpr int pad_bn() {
  return D > 256 ? WIDE_BN : D > 192 ? 64 : DEFAULT_BN;
}

// f(Int<SLABS>, Int<BN>) for the instantiated tile of bm query rows and bn
// keys at head dim D, else cudaErrorInvalidValue: rows 16, 32, 48, 64 and
// 80 by keys 64 and 128 at D = 128 (the head dim of the paged archs the
// card serves), rows 16, 32 and 64 by keys 64 and 128 at D = 160
// (pixtral-12b's: block_q 4, 8 and 16 at its G 4; 48 and 80 rows serve
// G 3 and G 5 only), the default 32 x 128 at the other head dims.  At D =
// 160 the 64 x 128 tile takes 193,536 B (bf16) and 199,680 B (int8)
// before the table.  Shared
// memory at 80 rows (tc::Smem at 64 table entries): 91,648 B (bf16, 64
// keys), 161,280 (bf16, 128), 94,720 (int8, 64) and 167,424 (int8, 128),
// all under the 227 KB a block may hold.  A padded instance has one tile,
// 32 rows by pad_bn<D>() keys.
template <int D, bool PAD, typename F>
cudaError_t with_tile(int bm, int bn, F&& f) {
  if constexpr (PAD) {
    if (bm == 16 * DEFAULT_SLABS && bn == pad_bn<D>())
      return f(Int<DEFAULT_SLABS>{}, Int<pad_bn<D>()>{});
  } else {
    if (bm == 16 * DEFAULT_SLABS && bn == DEFAULT_BN)
      return f(Int<DEFAULT_SLABS>{}, Int<DEFAULT_BN>{});
    if constexpr (D == 128 || D == 160) {
      if (bn == 64 || bn == 128) {
        auto keys = [&](auto slabs) {
          return bn == 64 ? f(slabs, Int<64>{}) : f(slabs, Int<128>{});
        };
        if (bm == 16) return keys(Int<1>{});
        if (bm == 32) return keys(Int<2>{});
        if (bm == 64) return keys(Int<4>{});
        if constexpr (D == 128) {
          if (bm == 48) return keys(Int<3>{});
          if (bm == 80) return keys(Int<5>{});
        }
      }
    }
  }
  return cudaErrorInvalidValue;
}

// f(Int<D>, pad) for the instance of head dim d: with dp = 0 the head
// dim's own (16, 32, 64, 128 and 160, the fold: G divides the tile), else
// the padded instance of width dp (common.cuh's with_pad_width), which
// takes the flattened rows and so any G.
template <typename F>
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
      case 128: return f(Int<128>{}, own);
      case 160: return f(Int<160>{}, own);
      default: return cudaErrorInvalidValue;
    }
  }
}

template <typename S, int D, int SLABS, int BN>
size_t smem_bytes(int nblk) {
  return Smem<S, D, SLABS, BN>::tbl_off + (size_t)nblk * sizeof(int);
}

template <typename S, int D, bool SPLIT, int SLABS, int BN, bool PAD>
cudaError_t launch(const Args& a, int G) {
  if (a.B < 1 || a.C < 1 || a.psz < 1 || a.nblk < 1 ||
      (SPLIT && a.ns < 1) || (a.cnt != nullptr && (!SPLIT || a.o == nullptr)))
    return cudaErrorInvalidValue;
  using T = Tile<SLABS, BN>;
  constexpr int THREADS = threads<D, SLABS, BN>();
  const size_t smem = smem_bytes<S, D, SLABS, BN>(a.nblk);
  auto kern = paged_prefill_tc_kernel<S, D, SPLIT, SLABS, BN, PAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // query tiles of BM consecutive rows of each kv head's C x G (position,
  // head) rows: ceil(C / (BM / G)) of them when G divides BM
  const int tiles = (a.C * G + T::BM - 1) / T::BM;
  const int ns = SPLIT ? a.ns : 1;
  const dim3 grid(tiles * ns, a.Hkv, a.B);
  kern<<<grid, THREADS, smem, a.st>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const S*>(a.kp),
      static_cast<const S*>(a.vp), a.ksc, a.vsc, a.table, a.start, a.kv_len,
      static_cast<__nv_bfloat16*>(a.o), a.pm, a.pl, a.pacc, a.cnt, a.H,
      a.Hkv, a.C, a.psz, a.nblk, ns, G, a.scale * kLog2e, a.D);
  return cudaGetLastError();
}

// The own instances build into two libraries (kernels/build.py's
// OWN_PARTS): those over bf16 pools (K4, K5b) without REPRO_INT8_POOLS and
// those over int8 pools (K6c, K6d) with it, so that the two compile side
// by side; the padded and wide parts hold both.  A library asked for an
// own instance over the other pools returns cudaErrorInvalidValue.
#ifndef REPRO_INT8_POOLS
#define REPRO_INT8_POOLS 0
#endif
template <typename S, bool PAD>
constexpr bool holds_pools() {
  return PAD || std::is_same_v<S, int8_t> == (REPRO_INT8_POOLS != 0);
}

// the launch at the tile of a.rows query rows (block_q x G rows where G
// divides them; on a padded instance, where a G that divides no row tile
// runs, a run of rows that may span no whole number of positions) and
// a.bn keys
template <typename S, bool SPLIT>
cudaError_t by_dim(const Args& a) {
  if (a.Hkv < 1 || a.H < a.Hkv || a.H % a.Hkv) return cudaErrorInvalidValue;
  const int G = a.H / a.Hkv;
  const int bm = a.rows > 0 ? a.rows : 16 * DEFAULT_SLABS;
  if (a.dp == 0 && bm % G != 0) return cudaErrorInvalidValue;
  return with_dim(a.D, a.dp, [&](auto w, auto pad) {
    constexpr int DD = decltype(w)::value;
    constexpr bool PAD = decltype(pad)::value;
    if constexpr (!holds_pools<S, PAD>()) {
      return cudaErrorInvalidValue;
    } else {
      return with_tile<DD, PAD>(bm, a.bn, [&](auto sl, auto bn) {
        return launch<S, DD, SPLIT, decltype(sl)::value, decltype(bn)::value,
                      PAD>(a, G);
      });
    }
  });
}

template <typename S, bool SPLIT, int D, int SLABS, int BN, bool PAD>
cudaError_t info_of(int nblk, int* out) {
  if constexpr (!holds_pools<S, PAD>()) {
    return cudaErrorInvalidValue;
  } else {
    return instance_info(paged_prefill_tc_kernel<S, D, SPLIT, SLABS, BN, PAD>,
                         threads<D, SLABS, BN>(),
                         smem_bytes<S, D, SLABS, BN>(nblk), out);
  }
}

template <int D, int SLABS, int BN, bool PAD>
cudaError_t info_by_kind(int kind, int nblk, int* out) {
  switch (kind) {
    case 0: return info_of<__nv_bfloat16, false, D, SLABS, BN, PAD>(nblk, out);
    case 1: return info_of<int8_t, false, D, SLABS, BN, PAD>(nblk, out);
    case 2: return info_of<__nv_bfloat16, true, D, SLABS, BN, PAD>(nblk, out);
    case 3: return info_of<int8_t, true, D, SLABS, BN, PAD>(nblk, out);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: the type of q and of the output; only 1 (bfloat16) is taken here
// (float32 goes to paged_attention.cu).  rows is the query tile's rows
// (0: the default, 32): consecutive rows of one kv head's C x G (position,
// head) rows, block_q positions of its G heads where G divides them;
// block_k its keys per K/V tile.  dp: 0 for the head dim D's own instance,
// else the width of the padded instance to run (kernels/
// paged_attention.py's prefill_route()).  A tile with no instance (see
// with_tile), or an own instance's tile that G does not divide, returns
// cudaErrorInvalidValue and launches nothing.  Each entry point returns the launch's cudaError_t (0 =
// success).  The caller validates shapes, contiguity, alignment and that
// every table entry below ceil(kv_len / psz) names a page of the pools,
// and allocates o or the partials; the kernels never allocate or sync.

// K4: bf16 pools.
extern "C" int repro_flash_paged_prefill(const void* q, const void* k_pool,
                                         const void* v_pool,
                                         const void* page_table,
                                         const void* start,
                                         const void* kv_len, void* o, int B,
                                         int H, int Hkv, int C, int psz,
                                         int nblk, int D, int dp, int rows,
                                         int block_k, int dtype, float scale,
                                         void* stream) {
  if (dtype != 1) return cudaErrorInvalidValue;
  Args a{q, k_pool, v_pool, nullptr, nullptr,
         static_cast<const int*>(page_table),
         static_cast<const int*>(start), static_cast<const int*>(kv_len),
         o, nullptr, nullptr, nullptr, B, H, Hkv, C, psz, nblk, 1, D,
         scale, static_cast<cudaStream_t>(stream), rows, block_k};
  a.dp = dp;
  return by_dim<__nv_bfloat16, false>(a);
}

// K6c: int8 pools with scales (P, Hkv, psz).
extern "C" int repro_flash_paged_prefill_quant(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* start, const void* kv_len, void* o, int B, int H, int Hkv,
    int C, int psz, int nblk, int D, int dp, int rows, int block_k, int dtype,
    float scale, void* stream) {
  if (dtype != 1) return cudaErrorInvalidValue;
  Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
         static_cast<const float*>(v_scale),
         static_cast<const int*>(page_table),
         static_cast<const int*>(start), static_cast<const int*>(kv_len),
         o, nullptr, nullptr, nullptr, B, H, Hkv, C, psz, nblk, 1, D,
         scale, static_cast<cudaStream_t>(stream), rows, block_k};
  a.dp = dp;
  return by_dim<int8_t, false>(a);
}

// K5b: bf16 pools, ns splits, partials m, l (B, H, ns, C), acc (.., D).
extern "C" int repro_paged_prefill_split_tc(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* start, const void* kv_len, void* m,
    void* l, void* acc, int B, int H, int Hkv, int C, int psz, int nblk,
    int ns, int D, int dp, int rows, int block_k, int dtype, float scale,
    void* stream) {
  if (dtype != 1) return cudaErrorInvalidValue;
  Args a{q, k_pool, v_pool, nullptr, nullptr,
         static_cast<const int*>(page_table),
         static_cast<const int*>(start), static_cast<const int*>(kv_len),
         nullptr, static_cast<float*>(m), static_cast<float*>(l),
         static_cast<float*>(acc), B, H, Hkv, C, psz, nblk, ns, D,
         scale, static_cast<cudaStream_t>(stream), rows, block_k};
  a.dp = dp;
  return by_dim<__nv_bfloat16, true>(a);
}

// K6d: int8 pools with scales (P, Hkv, psz), ns splits, partials as K5b's.
extern "C" int repro_paged_prefill_split_quant_tc(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* start, const void* kv_len, void* m, void* l, void* acc,
    int B, int H, int Hkv, int C, int psz, int nblk, int ns, int D, int dp,
    int rows, int block_k, int dtype, float scale, void* stream) {
  if (dtype != 1) return cudaErrorInvalidValue;
  Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
         static_cast<const float*>(v_scale),
         static_cast<const int*>(page_table),
         static_cast<const int*>(start), static_cast<const int*>(kv_len),
         nullptr, static_cast<float*>(m), static_cast<float*>(l),
         static_cast<float*>(acc), B, H, Hkv, C, psz, nblk, ns, D,
         scale, static_cast<cudaStream_t>(stream), rows, block_k};
  a.dp = dp;
  return by_dim<int8_t, true>(a);
}

// K5b with K5c's merge in its epilogue: as repro_paged_prefill_split_tc,
// and the last split of each (lane, kv head, q tile) to finish writes o
// (B, H, C, D) bf16.  counters: B * Hkv * ceil(C * G / rows) int32, all
// zero on entry, all zero again when the launch has run; one set per
// stream.
extern "C" int repro_paged_prefill_split_merged_tc(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* start, const void* kv_len, void* m,
    void* l, void* acc, void* o, void* counters, int B, int H, int Hkv, int C,
    int psz, int nblk, int ns, int D, int dp, int rows, int block_k, float scale,
    void* stream) {
  Args a{q, k_pool, v_pool, nullptr, nullptr,
         static_cast<const int*>(page_table), static_cast<const int*>(start),
         static_cast<const int*>(kv_len), o, static_cast<float*>(m),
         static_cast<float*>(l), static_cast<float*>(acc), B, H, Hkv, C, psz,
         nblk, ns, D, scale, static_cast<cudaStream_t>(stream), rows,
         block_k};
  a.cnt = static_cast<int*>(counters);
  if (a.cnt == nullptr) return cudaErrorInvalidValue;
  a.dp = dp;
  return by_dim<__nv_bfloat16, true>(a);
}

// K6d with K5c's merge in its epilogue: int8 pools with scales, the rest
// as repro_paged_prefill_split_merged_tc.
extern "C" int repro_paged_prefill_split_quant_merged_tc(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* start, const void* kv_len, void* m, void* l, void* acc,
    void* o, void* counters, int B, int H, int Hkv, int C, int psz, int nblk,
    int ns, int D, int dp, int rows, int block_k, float scale, void* stream) {
  Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
         static_cast<const float*>(v_scale),
         static_cast<const int*>(page_table), static_cast<const int*>(start),
         static_cast<const int*>(kv_len), o, static_cast<float*>(m),
         static_cast<float*>(l), static_cast<float*>(acc), B, H, Hkv, C, psz,
         nblk, ns, D, scale, static_cast<cudaStream_t>(stream), rows,
         block_k};
  a.cnt = static_cast<int*>(counters);
  if (a.cnt == nullptr) return cudaErrorInvalidValue;
  a.dp = dp;
  return by_dim<int8_t, true>(a);
}

// The instance for head dim D and a tile of bm query rows and block_k
// keys of kind 0 (K4: bf16 pools, one pass), 1 (K6c: int8 pools), 2 (K5b:
// bf16 pools, partials) or 3 (K6d: int8 pools, partials): out[0..3] =
// registers per thread, local-memory (spill) bytes, dynamic shared memory
// in bytes at nblk table entries, resident blocks per SM.
extern "C" int repro_paged_prefill_tc_info(int D, int dp, int kind, int nblk,
                                           int bm, int block_k, int* out) {
  return with_dim(D, dp, [&](auto w, auto pad) {
    constexpr int DD = decltype(w)::value;
    constexpr bool PAD = decltype(pad)::value;
    return with_tile<DD, PAD>(bm, block_k, [&](auto sl, auto bn) {
      return info_by_kind<DD, decltype(sl)::value, decltype(bn)::value, PAD>(
          kind, nblk, out);
    });
  });
}
