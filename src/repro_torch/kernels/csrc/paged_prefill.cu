// Paged chunked prefill on Hopper's tensor cores (sm_90a): the one-pass
// (num_splits <= 1) attention of a prefill or verify chunk with a bf16
// query, against bf16 K/V page pools (P, Hkv, psz, D) or int8 pools with
// per-row fp32 scales (P, Hkv, psz), each sequence reaching its pages
// through a row of a page table (B, nblk) int32.  Plain C interface, bound
// from Python with ctypes (kernels/paged_attention.py); no PyTorch headers.
//
// Replaces the one-pass Pallas kernels of src/repro/kernels/flash_attention.py:
// K4  paged_prefill_tc_kernel<bf16>  flash_paged_prefill (:668) /
//                                    _paged_prefill_kernel (pallas_call :733)
// K6c paged_prefill_tc_kernel<int8>  flash_paged_prefill_quant (:1126) /
//                                    _paged_prefill_quant_kernel (:1186)
// A float32 query keeps paged_attention.cu's SIMT template (a TF32 product
// would break the fp32 tolerance); the wrapper picks by the query's type.
// The split forms K5b/K6d stay on that template too.
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
// fp32 version does not make is P (or P * v_scale) to bf16: at most 2^-9
// of max |v| on an output; the row sums l are taken from the fp32 P.
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
// Left for later: splitting one query tile's key walk over blocks (K5b's
// partials mode) for grids far below the SM count (the verify shape has
// 40 blocks), wgmma and TMA.

#include "common.cuh"

namespace {

namespace tc {
constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
constexpr int BN = 128;           // keys per K/V tile
constexpr int STAGES = 2;         // ring of K/V tiles in flight
constexpr float kLog2e = 1.4426950408889634f;

// The warps of a block: SLABS 16-row mma slabs of the BM-row query tile
// times KGROUPS key groups, group kg taking keys kg * KN .. kg * KN + KN - 1
// of every K/V tile.
constexpr int SLABS = 2;
constexpr int BM = 16 * SLABS;
constexpr int KGROUPS = NWARPS / SLABS;
constexpr int KN = BN / KGROUPS;

// Dynamic shared memory of one block, in bytes: the Q tile (bf16 rows of
// D + 8), the ring of K and V tiles as stored (rows of D * sizeof(S) + 16
// bytes), for int8 pools the bf16 K and V tiles the codes widen to and the
// ring's per-row scales, then the lane's live page-table entries.
template <typename S, int D>
struct Smem {
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
  static constexpr size_t tbl_off = vs_off + scale_bytes;
  // after the walk the ring (and the widened tiles) hold the softmax
  // states of key groups 1.., in the fragment layout: per (group, slab,
  // lane) m[2], l[2], acc[D / 8][4]
  static constexpr int MERGE = 4 + D / 2;   // floats per lane
  static constexpr size_t merge_bytes =
      (size_t)(KGROUPS - 1) * SLABS * 32 * MERGE * 4;
  static_assert(merge_bytes <= ks_off - k_off, "merge space");
};
}  // namespace tc

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared without the registers; src_bytes 0
// writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// four int8 codes of one word -> two registers of two bf16, exactly and on
// the full-rate ALUs: code c sits as byte c + 128 in the float 2^23 + c +
// 128, so subtracting 2^23 + 128 leaves c; |c| <= 127 has at most 8
// significant bits, so the float's low 16 bits are 0 and its high half is
// bf16(c)
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;
  constexpr float kMagic = 8388736.f;   // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - kMagic;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - kMagic;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - kMagic;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - kMagic;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// 8 int8 codes (8-byte aligned) -> 8 bf16 (16-byte aligned)
__device__ __forceinline__ void widen8(const int8_t* src, __nv_bfloat16* dst) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  uint4 out;
  widen4(raw.x, out.x, out.y);
  widen4(raw.y, out.z, out.w);
  *reinterpret_cast<uint4*>(dst) = out;
}

// ---------------------------------------------------------------------------
// K4 / K6c: q (B, H, C, D) bf16, pools (P, Hkv, psz, D) of S (bf16, or int8
// with scales (P, Hkv, psz) fp32), table (B, nblk), start and kv_len (B,)
// int32 -> o (B, H, C, D) bf16.  Grid (ceil(C / (BM >> gshift)), Hkv, B);
// G = 1 << gshift query heads per kv head, dividing BM = 32;
// scale_log2 = scale * log2(e), so the softmax runs on exp2.
// ---------------------------------------------------------------------------

template <typename S, int D>
__global__ void __launch_bounds__(tc::THREADS)
paged_prefill_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const S* __restrict__ kp, const S* __restrict__ vp,
                        const float* __restrict__ ksc,
                        const float* __restrict__ vsc,
                        const int* __restrict__ table,
                        const int* __restrict__ start,
                        const int* __restrict__ kv_len,
                        __nv_bfloat16* __restrict__ o, int H, int Hkv, int C,
                        int psz, int nblk, int gshift, float scale_log2) {
  using namespace tc;
  using L = Smem<S, D>;
  constexpr bool QUANT = L::QUANT;
  constexpr int ROW = L::ROW;
  constexpr int KV_ROW = L::KV_ROW;
  constexpr int CPR = D * (int)sizeof(S) / 16;  // 16-byte copies per K/V row
  constexpr int QCPR = D * 2 / 16;              // and per q row
  constexpr int NT = KN / 8;                    // 8-key column tiles of S
  constexpr int DT = D / 8;                     // 8-wide column tiles of O
  constexpr int KT = D / 16;                    // 16-deep steps of QK^T
  static_assert(THREADS >= BN && D % 16 == 0 && KN % 16 == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* k_ring = smem + L::k_off;
  unsigned char* v_ring = smem + L::v_off;
  float* ks_ring = reinterpret_cast<float*>(smem + L::ks_off);
  float* vs_ring = reinterpret_cast<float*>(smem + L::vs_off);
  int* tbl = reinterpret_cast<int*>(smem + L::tbl_off);

  const int G = 1 << gshift;
  const int RQ = BM >> gshift;          // chunk rows per tile
  const int i0 = blockIdx.x * RQ;       // the tile's first chunk row
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int len = min(max(kv_len[b], 0), nblk * psz);
  const int q_start = start[b] + i0;    // absolute position of row i0
  // live key tiles: committed and causally visible to the tile's last row
  const int last = q_start + RQ - 1;
  const int n_tiles = last < 0 ? 0 : min((len + BN - 1) / BN, last / BN + 1);
  const int n_pages = (min(len, n_tiles * BN) + psz - 1) / psz;

  // Q tile: row r is chunk row i0 + (r >> gshift) of head hk * G + (r & (G-1));
  // rows past the chunk are zeros, never stored
  for (int i = tid; i < BM * QCPR; i += THREADS) {
    const int r = i / QCPR;
    const int c = i - r * QCPR;
    const int qi = i0 + (r >> gshift);
    const bool in = qi < C;
    const __nv_bfloat16* src =
        in ? q + (((size_t)b * H + hk * G + (r & (G - 1))) * C + qi) * D + c * 8
           : q;
    cp_async16(smem_addr(qs + r * ROW + c * 8), src, in ? 16 : 0);
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
      size_t off = 0;
      if (in) {
        const int blk = key / psz;
        off = (((size_t)tbl[blk] * Hkv + hk) * psz + (key - blk * psz)) * D +
              c * (16 / (int)sizeof(S));
      }
      cp_async16(smem_addr(kd + j * KV_ROW + c * 16), kp + off, in ? 16 : 0);
      cp_async16(smem_addr(vd + j * KV_ROW + c * 16), vp + off, in ? 16 : 0);
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

  // group s holds tile s (group 0 also Q); one group is committed per
  // tile even when empty, so wait_group counts stay uniform
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }

  const int row0 = (warp % SLABS) * 16; // the warp's 16-row slab
  const int kg = warp / SLABS;          // and its keys kg * KN .. + KN - 1
  const int g = lane >> 2;              // the thread's rows: row0 + g, + 8
  const int t4 = lane & 3;              // and columns 2 * t4, + 1 of each tile
  const int pos0 = q_start + ((row0 + g) >> gshift);
  const int pos1 = q_start + ((row0 + g + 8) >> gshift);
  const int warp_pos = q_start + (row0 >> gshift);   // the slab's first row

  float m[2] = {kNegInf, kNegInf};      // running max, log2 domain
  float l[2] = {0.f, 0.f};              // this thread's share of the row sums
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  uint32_t qf[KT][4];

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t has landed; the stage of tile t - 1 is free
    if (t + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1, (t + STAGES - 1) % STAGES);
    cp_async_commit();
    const int stage = t % STAGES;

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

    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        ldsm4(smem_addr(qs + (row0 + (lane & 15)) * ROW + kk * 16 + (lane >> 4) * 8),
              qf[kk]);
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
        const int key = kg * KN + np * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int col = kk * 16 + (((lane >> 3) & 1) << 3);
        ldsm4(smem_addr(kt + key * ROW + col), bk);
        mma16816(s[2 * np], qf[kk], bk[0], bk[1]);
        mma16816(s[2 * np + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // scale (and key scales), mask, online softmax in fp32
    const int k0 = t * BN + kg * KN;      // the warp's first key
    const bool need_mask = k0 + KN > len || k0 + KN - 1 > warp_pos;
    const float* ksc_t = ks_ring + stage * BN + kg * KN;
    const float* vsc_t = vs_ring + stage * BN + kg * KN;
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
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        const int key = kg * KN + kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
        const int col = dp * 16 + ((lane >> 4) << 3);
        ldsm4_trans(smem_addr(vt + key * ROW + col), bv);
        mma16816(acc[2 * dp], pa[kk], bv[0], bv[1]);
        mma16816(acc[2 * dp + 1], pa[kk], bv[2], bv[3]);
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
  if (kg > 0) return;
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
  }

  // normalise and store the chunk's rows; no key seen leaves acc = 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const int row = row0 + g + 8 * r;
    const int qi = i0 + (row >> gshift);
    if (qi >= C) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    __nv_bfloat16* dst =
        o + (((size_t)b * H + hk * G + (row & (G - 1))) * C + qi) * D + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8) =
          pack_bf16(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
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
  void* o;
  int B, H, Hkv, C, psz, nblk, D;
  float scale;
  cudaStream_t st;
};

// log2 of the group size G = H / Hkv, or -1 when G is not a power of two
// dividing the query tile
int group_shift(int H, int Hkv) {
  if (Hkv < 1 || H % Hkv) return -1;
  const int G = H / Hkv;
  for (int s = 0; (1 << s) <= BM; ++s)
    if ((1 << s) == G) return s;
  return -1;
}

template <typename S, int D>
size_t smem_bytes(int nblk) {
  return Smem<S, D>::tbl_off + (size_t)nblk * sizeof(int);
}

template <typename S, int D>
cudaError_t launch(const Args& a) {
  const int gshift = group_shift(a.H, a.Hkv);
  if (gshift < 0 || a.B < 1 || a.C < 1 || a.psz < 1 || a.nblk < 1)
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<S, D>(a.nblk);
  auto kern = paged_prefill_tc_kernel<S, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = BM >> gshift;
  const dim3 grid((a.C + rows - 1) / rows, a.Hkv, a.B);
  kern<<<grid, THREADS, smem, a.st>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const S*>(a.kp),
      static_cast<const S*>(a.vp), a.ksc, a.vsc, a.table, a.start, a.kv_len,
      static_cast<__nv_bfloat16*>(a.o), a.H, a.Hkv, a.C, a.psz, a.nblk,
      gshift, a.scale * kLog2e);
  return cudaGetLastError();
}

template <typename S>
cudaError_t by_dim(const Args& a) {
  switch (a.D) {
    case 16: return launch<S, 16>(a);
    case 32: return launch<S, 32>(a);
    case 64: return launch<S, 64>(a);
    case 128: return launch<S, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

// what the card makes of one instance: registers, local (spill) bytes,
// dynamic shared memory at nblk table entries, resident blocks per SM
template <typename S, int D>
cudaError_t info(int nblk, int* out) {
  cudaFuncAttributes attr;
  auto kern = paged_prefill_tc_kernel<S, D>;
  const size_t smem = smem_bytes<S, D>(nblk);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                        THREADS, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return cudaSuccess;
}

}  // namespace

// dtype: the type of q and of the output; only 1 (bfloat16) is taken here
// (float32 goes to paged_attention.cu).  Each entry point returns the
// launch's cudaError_t (0 = success).  The caller validates shapes,
// contiguity, alignment and that every table entry below ceil(kv_len /
// psz) names a page of the pools, and allocates o; the kernels never
// allocate or sync.

// K4: bf16 pools.
extern "C" int repro_flash_paged_prefill(const void* q, const void* k_pool,
                                         const void* v_pool,
                                         const void* page_table,
                                         const void* start,
                                         const void* kv_len, void* o, int B,
                                         int H, int Hkv, int C, int psz,
                                         int nblk, int D, int dtype,
                                         float scale, void* stream) {
  if (dtype != 1) return cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, nullptr, nullptr,
               static_cast<const int*>(page_table),
               static_cast<const int*>(start), static_cast<const int*>(kv_len),
               o, B, H, Hkv, C, psz, nblk, D, scale,
               static_cast<cudaStream_t>(stream)};
  return by_dim<__nv_bfloat16>(a);
}

// K6c: int8 pools with scales (P, Hkv, psz).
extern "C" int repro_flash_paged_prefill_quant(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* start, const void* kv_len, void* o, int B, int H, int Hkv,
    int C, int psz, int nblk, int D, int dtype, float scale, void* stream) {
  if (dtype != 1) return cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(page_table),
               static_cast<const int*>(start), static_cast<const int*>(kv_len),
               o, B, H, Hkv, C, psz, nblk, D, scale,
               static_cast<cudaStream_t>(stream)};
  return by_dim<int8_t>(a);
}

// The instance for head dim D over bf16 (quant 0) or int8 (1) pools:
// out[0..3] = registers per thread, local-memory (spill) bytes, dynamic
// shared memory in bytes at nblk table entries, resident blocks per SM.
extern "C" int repro_paged_prefill_tc_info(int D, int quant, int nblk,
                                           int* out) {
  switch (D * 2 + (quant ? 1 : 0)) {
    case 32: return info<__nv_bfloat16, 16>(nblk, out);
    case 33: return info<int8_t, 16>(nblk, out);
    case 64: return info<__nv_bfloat16, 32>(nblk, out);
    case 65: return info<int8_t, 32>(nblk, out);
    case 128: return info<__nv_bfloat16, 64>(nblk, out);
    case 129: return info<int8_t, 64>(nblk, out);
    case 256: return info<__nv_bfloat16, 128>(nblk, out);
    case 257: return info<int8_t, 128>(nblk, out);
    default: return cudaErrorInvalidValue;
  }
}
