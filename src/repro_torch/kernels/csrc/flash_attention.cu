// Flash attention for Hopper (sm_90a): self- and cross attention for
// prefill (K1) and one-token decode against a dense KV cache (K2).  Plain C interface, bound
// from Python with ctypes (kernels/flash_attention.py); no PyTorch headers.
//
// K1  flash_attention_tc_kernel  (bf16) and flash_attention_kernel (float32)
//     replace the TPU kernel src/repro/kernels/flash_attention.py:
//     flash_attention / _attn_kernel.
// K2  flash_decode_kernel        (float32) replaces the TPU kernel
//     src/repro/kernels/flash_attention.py: flash_decode / _decode_kernel;
//     a bf16 query runs the DENSE mode of paged_decode.cu's cluster
//     kernel instead (the wrapper picks by the query's type).
//
// Semantics kept from the TPU kernels: the online softmax runs in fp32,
// masked scores are -1e30 (not -inf), fully masked key tiles are skipped,
// and a row whose denominator is 0 (no key visible, e.g. kv_len == 0 in
// K2) yields exactly 0.  GQA maps query head h to kv head h / (H / Hkv),
// for any H % Hkv == 0.  The float32 kernels take every product in fp32;
// the bf16 K1 takes Q.K^T and P.V as bf16 products summed in fp32, so its
// one rounding the plain fp32 version does not make is P to bf16 before
// P.V: at most 2^-8 (bf16's unit roundoff) of max |v| on an output (the
// row sums l come from the fp32 P).
//
// K1 takes S query rows and Sk keys of its own: Sk = S for self-attention
// (causal, windowed or not), Sk != S for whisper's cross attention (the
// decoder's prompt over the encoder's 1500 frames), which is never causal
// or windowed (the launcher refuses the mix).  The grid runs over the
// query rows' tiles and the key walk to Sk; rows past S and keys past Sk
// in the last tiles are zero-filled and masked.  The TPU kernel asserts
// S == Sk, so on a TPU the JAX package's cross attention cannot take it;
// its plain version (ref.attention_ref, the ends aligned) computes the
// function this kernel computes.  A short prompt wastes the tile: 4
// query rows take a 64-row tile's products (16 a warp, 4 warps), so the
// cross call at whisper's start-of-transcript shape is bound by its 1500
// keys' copies, not by its rows.
//
// What bounds them on an H100.  K1 at a yi-6b prefill of 512 tokens (H 32,
// Hkv 4, D 128, causal) must read Q, K, V and write O once, 9.4 MB: 2.8 us
// at 3.35 TB/s; its 2.2 GFLOP of causal QK^T and P.V take 2.2 us at 989
// TFLOP/s.  Both are microseconds, so what the kernel pays is latency and
// balance.  K2 at every decode step is memory-bound: it must read
// B*Hkv*kv_len*D*2 (K and V) elements once per step.
//  * K1 bf16 (flash_attention_tc_kernel), the tensor-core design of
//    paged_prefill.cu on dense K/V, in place of a SIMT kernel that ran at
//    73x its bound and 11x torch's SDPA:
//     - Q.K^T and P.V are mma.sync.m16n8k16 bf16 with fp32 accumulators,
//       fed by ldmatrix (.trans for V) from shared rows padded by 16 bytes
//       (conflict-free); S and the online softmax stay in fp32 registers
//       (exp2 of scores scaled by scale * log2 e, row max by quad
//       shuffles); P is packed to bf16 in registers as the A operand of
//       P.V;
//     - one block per (batch, head, BM-row query tile), one warp per
//       16-row slab, each slab walking every live key tile in steps of 64
//       keys; a warp skips a step none of whose keys its slab sees (the
//       diagonal, the window's edge).  A row that has seen no visible
//       key yet keeps m = -1e30 and subtracts 0, so its masked keys weigh
//       0, not 1: the window can hide a whole step from some rows of a
//       slab whose other rows see it;
//     - K/V tiles arrive by 16-byte cp.async copies into a ring of 2
//       stages (tile t + 1 in flight while tile t is multiplied; keys past
//       S zero-filled, masked); Q's fragments are loaded once a block.
//       At the default 64 x 64 tile and D=128 that is 87 KB of shared
//       memory and ~210 registers a thread, 2 blocks and 8 warps an SM:
//       at S=512, H=32 the 256 blocks fit in one wave on 132 SMs;
//     - K/V are contiguous per kv head, so there is no GQA fold: the G
//       query heads of a kv head are G blocks that read the same K/V
//       rows, from L2 after the first (one head's K and V at S=512 are
//       256 KB), and any G works (phi4-mini's G = 3 too);
//     - the causal walk is unbalanced (query tile i walks i + 1 key
//       tiles), so blockIdx.x runs over query tiles in reverse: the heavy
//       tiles start first, as in FlashAttention-2.
//    Measured against variants of the block (8 warps in 2 key groups as
//    K4 has, 128-row tiles, 32- and 128-key tiles, 3 and 4 stages, Q
//    read from shared memory at each tile), this shape was the fastest at
//    every size timed.  Taking parts out in turn at S=512, the products,
//    the K/V copies and the rest (the launch, Q's read, the softmax, the
//    store) each take about a third of the kernel's time; the copies'
//    third stays whatever the ring's depth (each 64-row tile copies its
//    kv head's causal prefix again, ~38 MB from L2 in all; 128-row tiles
//    halve that but fit one block of 8 warps an SM and were no faster),
//    and torch's SDPA pulls further ahead as the work grows.  Left for
//    later: wgmma, whose warpgroup tiles take their operands from shared
//    memory, so a block can hold more rows per copied key tile, and TMA.
//    The tile is the install-time AT's FlashBlocks region (block_q query
//    rows x block_k keys, tuning/install.py): 64 x 64 by default, and at
//    D = 128, 80, 112 and 160 also 64 x 128, 128 x 64 and 128 x 128.  block_q sets the
//    warps of a block (BM / 16) and so how many query rows share each
//    copied K/V tile; block_k the keys of one copy (a ring stage), walked
//    in 64-key softmax steps, so every tile takes the same steps in the
//    same order and gives the same bits.  Shared memory at D = 128: 87,
//    157, 104 and 174 KB (Smem); the 128-key tiles fit one block an SM,
//    and so do the 128-row ones (8 warps of ~210 registers).
//    D = 80 (h2o-danube-1.8b) is the same body: 5 k-steps of m16n8k16 for
//    S, 10 n-tiles of 8 for P.V (5 ldmatrix.x4.trans pairs), rows of 88
//    bf16 (176 bytes: 10 cp.async chunks, 16-byte aligned, and 8 rows of
//    an ldmatrix fall in distinct bank quads), 56, 101, 68 and 113 KB of
//    shared memory at the four tiles.  D = 112 (zamba2-7b's shared block)
//    likewise: 7 k-steps, 14 n-tiles (7 pairs), rows of 120 bf16 (240
//    bytes: 15 chunks, so 8 rows of an ldmatrix start in distinct bank
//    quads), 75, 135, 90 and 150 KB (153,600 B at 128 x 128).  D = 160
//    (pixtral-12b) likewise: 10 k-steps, 20 n-tiles (10 pairs), rows of
//    168 bf16 (336 bytes: 21 chunks, odd, so 8 rows of an ldmatrix start
//    in distinct bank quads), 107,520, 193,536, 129,024 and 215,040 B; a
//    thread holds its slab's Q fragments (40 registers) and O (80 fp32).
//    Above 256 the wide rungs 384 and 512: one 32 x 32 tile, each 16-row
//    slab served by D / 128 warps, one per 128 columns (k1tc's notes,
//    common.cuh).
//  * K1 float32 (flash_attention_kernel): SIMT fp32, one block of 4 warps
//    per (batch, head, 64-row query tile; 8 warps of 32 rows above 256);
//    K/V tiles of 32 keys staged in shared memory as fp32 (lane j of a
//    warp owns key j of the tile, so the row max and sum are warp
//    shuffles); each warp owns 16 query rows and keeps their output rows
//    in registers.  A TF32 product would break the fp32 tolerance.
//  * K2 float32: one block of 8 warps per (batch, kv head) holding the G
//    grouped query rows (the same fold as the TPU kernel), so each K/V
//    element is read from device memory once for all G rows (a group of
//    more than 8 rows is split into blocks of 8, 4 or 2 along
//    blockIdx.y).  The warps split the cache into interleaved 32-key
//    tiles up to kv_len[b] only, each with its own online softmax state,
//    merged at the end by a max-shift in shared memory.  At 4 lanes of yi-6b that is 16 blocks on
//    132 SMs: the card is mostly idle.  The bf16 K2 of the main path is
//    therefore paged_decode.cu's cluster kernel (c CTAs per lane and kv
//    head, cp.async rows, mma.sync); this one keeps the fp32 products the
//    float32 tolerance needs.

#include "mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// K1: self-attention, q (B, H, S, D), k/v (B, Hkv, S, D), o like q.
// ---------------------------------------------------------------------------

namespace k1 {
constexpr int BQ = 64;             // query rows per block
constexpr int BK = 32;             // keys per tile: lane j owns key j
constexpr int NWARPS = 4;
constexpr int THREADS = NWARPS * 32;
constexpr int RPW = BQ / NWARPS;   // query rows per warp

// The wide instances (D > 256) take 32 query rows in 8 warps, 4 rows a
// warp: a lane's O is then 4 x D / 32 fp32 (64 at D = 512, where 16 rows
// a warp would hold 256), and the block's shared memory 200,832 B at D =
// 512 (151,680 at 384), where 64 rows would need 270,464, more than the
// 232,448 a block may hold.  One block an SM; the products stay fp32
// (ptxas: 220 registers at 512, 132 at 384, no spill).
template <int D>
__host__ __device__ constexpr int bq() { return D > 256 ? 32 : BQ; }
template <int D>
__host__ __device__ constexpr int nwarps() { return D > 256 ? 8 : NWARPS; }
template <int D>
__host__ __device__ constexpr int threads() { return nwarps<D>() * 32; }

template <int D>
constexpr size_t smem_bytes() {
  // Q tile, K tile (rows padded to D + 1 so lane j reading key j's column
  // c hits bank (j + c) % 32), V tile, the warps' softmax numerators
  return sizeof(float) *
         (bq<D>() * D + BK * (D + 1) + BK * D + bq<D>() * BK);
}
}  // namespace k1

template <typename T, int D, bool PAD>
__global__ void __launch_bounds__(k1::threads<D>())
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int Hkv, int S, int Sk, int causal, int window,
                       float scale, int d_run) {
  using namespace k1;
  constexpr int BQ = bq<D>();        // query rows per block
  constexpr int THREADS = threads<D>();
  constexpr int RPW = BQ / nwarps<D>();   // query rows per warp
  constexpr int NC = (D + 31) / 32;  // output columns per lane
  constexpr int KS = D + 1;
  const int d = PAD ? d_run : D;     // the row stride (common.cuh)
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + BQ * D;
  float* vs = ks + BK * KS;
  float* ps = vs + BK * D;

  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t qoff = ((size_t)b * H + h) * S * d;
  const size_t koff = ((size_t)b * Hkv + hk) * Sk * d;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * RPW;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int qi = q_start + i / D;
    if constexpr (PAD) {
      const int c = i % D;
      qs[i] = qi < S && c < d ? to_float(q[qoff + (size_t)qi * d + c]) : 0.f;
    } else {
      qs[i] = qi < S ? to_float(q[qoff + (size_t)q_start * D + i]) : 0.f;
    }
  }

  // live key tiles: causal needs k_start <= the tile's last query; the
  // window needs the tile's last key inside the first query's window
  const int n_k = (Sk + BK - 1) / BK;
  int t_lo = 0, t_hi = n_k;
  if (causal) t_hi = min(n_k, (q_start + BQ - 1) / BK + 1);
  if (window > 0) {
    const int lo = q_start - window - BK + 2;  // first live k_start
    if (lo > 0) t_lo = (lo + BK - 1) / BK;
  }

  float m[RPW], l[RPW], acc[RPW][NC];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k_start = t * BK;
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D;
      const int c = i - j * D;
      const bool in = k_start + j < Sk && (!PAD || c < d);
      const size_t g = PAD ? koff + (size_t)(k_start + j) * d + c
                           : koff + (size_t)k_start * D + i;
      ks[j * KS + c] = in ? to_float(k[g]) : 0.f;
      vs[i] = in ? to_float(v[g]) : 0.f;
    }
    __syncthreads();

    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float* kr = ks + lane * KS + c;
      const float k0 = kr[0], k1v = kr[1], k2 = kr[2], k3 = kr[3];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + (r0 + r) * D + c);
        s[r] += qv.x * k0 + qv.y * k1v + qv.z * k2 + qv.w * k3;
      }
    }

    const int kj = k_start + lane;
#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int qi = q_start + r0 + r;
      bool live = kj < Sk;
      if (causal) live = live && qi >= kj;
      if (window > 0) live = live && (qi - kj) < window;
      const float x = live ? s[r] * scale : kNegInf;
      const float m_cur = fmaxf(m[r], warp_max(x));
      const float p = expf(x - m_cur);
      const float alpha = expf(m[r] - m_cur);
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_cur;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= alpha;
      ps[(r0 + r) * BK + lane] = p;
    }
    __syncwarp();

#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float vv[4][NC];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = lane + 32 * c;
          vv[jj][c] = col < D ? vs[(j + jj) * D + col] : 0.f;
        }
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(ps + (r0 + r) * BK + j);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[r][c] += p4.x * vv[0][c] + p4.y * vv[1][c] + p4.z * vv[2][c] +
                       p4.w * vv[3][c];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qi = q_start + r0 + r;
    if (qi >= S) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < d) o[qoff + (size_t)qi * d + col] = from_float<T>(acc[r][c] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// K1 on the tensor cores: q (B, H, S, D), k/v (B, Hkv, S, D), o like q,
// all bf16.  Grid (ceil(S / BM), H, B), query tile gridDim.x - 1 -
// blockIdx.x; scale_log2 = scale * log2(e), so the softmax runs on exp2.
// The tile, template parameters: BM query rows (one 16-row mma slab a
// warp) and BN keys per K/V copy (a stage of the ring), walked in steps
// of STEP keys.
// ---------------------------------------------------------------------------

namespace k1tc {
constexpr int STAGES = 2;               // ring of K/V tiles in flight
constexpr int STEP = 64;                // keys per online-softmax step
constexpr int DEFAULT_BM = 64;          // the tile of an untuned launch
constexpr int DEFAULT_BN = 64;
// The wide instances (D > 256, common.cuh): one tile, 32 rows (2 slabs of
// D / 128 warps each) by 32 keys, walked in one 32-key step
constexpr int WIDE_BM = 32;
constexpr int WIDE_BN = 32;
template <int D>
__host__ __device__ constexpr int step() { return D > 256 ? WIDE_BN : STEP; }

template <int BM_, int BN_>
struct Tile {
  static constexpr int BM = BM_;
  static constexpr int BN = BN_;
  static constexpr int NWARPS = BM / 16;
  static constexpr int THREADS = NWARPS * 32;
};

// The warps of a block: one a 16-row slab, times the slab's column slices
// at the wide instances
template <int D, int BM, int BN>
__host__ __device__ constexpr int threads() {
  return Tile<BM, BN>::THREADS * head_slices<D>();
}

// Dynamic shared memory of one block: the Q tile and the ring of K and V
// tiles, bf16 rows of D + 8 elements; at the wide instances then the
// slices' partial S of each slab (sum_slices), fp32.  At D = 512 (384):
// 33,280 (25,088) + 133,120 (100,352) + 16,384 (12,288) = 182,784
// (137,728) B, one block an SM; a thread holds its slice's 32 Q fragment
// registers and 64 fp32 of O (ptxas: 188 registers at both rungs, no
// spill).
template <int D, int BM, int BN>
struct Smem {
  static constexpr int ROW = D + 8;
  static constexpr size_t q_bytes = (size_t)BM * ROW * 2;
  static constexpr size_t stage_bytes = (size_t)BN * ROW * 2;
  static constexpr size_t k_off = q_bytes;
  static constexpr size_t v_off = k_off + STAGES * stage_bytes;
  static constexpr size_t sp_off = v_off + STAGES * stage_bytes;
  static constexpr size_t sp_bytes =
      D > 256 ? (size_t)(BM / 16) * head_slices<D>() * step<D>() * 16 * 4 : 0;
  static constexpr size_t bytes = sp_off + sp_bytes;
};

// Resident blocks an SM that the launch bounds ask for: 2 for a 4-warp
// block whose shared memory fits twice in an SM's 228 KB (with the 1 KB
// the card reserves a block), else 1.  A thread of any tile holds ~210
// registers (its slab's Q fragments, O accumulator and one step's S), so
// 8 warps fit once: two 8-warp blocks would cap a thread at 128 and spill.
template <int D, int BM, int BN>
constexpr int min_blocks() {
  return Tile<BM, BN>::NWARPS == 4 &&
                 2 * (Smem<D, BM, BN>::bytes + 1024) <= 228 * 1024
             ? 2 : 1;
}
}  // namespace k1tc

template <int D, int BM, int BN, bool PAD>
__global__ void __launch_bounds__(k1tc::threads<D, BM, BN>(),
                                  k1tc::min_blocks<D, BM, BN>())
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o, int H, int Hkv,
                          int S, int Sk, int causal, int window,
                          float scale_log2, int d_run) {
  using namespace k1tc;
  using L = Smem<D, BM, BN>;
  constexpr bool WIDE = D > 256;    // the head dim split across warps
  constexpr int NS = head_slices<D>();   // column slices of a slab
  constexpr int SW = D / NS;        // a slice's columns
  constexpr int SK = step<D>();     // keys per online-softmax step
  constexpr int THREADS = threads<D, BM, BN>();
  constexpr int ROW = L::ROW;
  constexpr int CPR = D * 2 / 16;   // 16-byte copies per row
  constexpr int NT = SK / 8;        // 8-key column tiles of S
  constexpr int DT = SW / 8;        // 8-wide column tiles of O
  constexpr int KT = SW / 16;       // 16-deep steps of QK^T
  static_assert(D % 16 == 0 && BM % 16 == 0 && BN % SK == 0, "tile shape");

  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);
  __nv_bfloat16* k_ring = reinterpret_cast<__nv_bfloat16*>(tc_smem + L::k_off);
  __nv_bfloat16* v_ring = reinterpret_cast<__nv_bfloat16*>(tc_smem + L::v_off);

  const int d = PAD ? d_run : D;        // the row stride (common.cuh)
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;  // heavy tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const __nv_bfloat16* qh = q + ((size_t)b * H + h) * S * d;
  const size_t kv_off = ((size_t)b * Hkv + h / (H / Hkv)) * Sk * d;
  const __nv_bfloat16* kh = k + kv_off;
  const __nv_bfloat16* vh = v + kv_off;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // live key tiles: causal needs k_start <= the tile's last query; the
  // window needs the tile's last key inside the first query's window
  const int n_k = (Sk + BN - 1) / BN;
  int t_lo = 0, t_hi = n_k;
  if (causal) t_hi = min(n_k, (q0 + BM - 1) / BN + 1);
  if (window > 0) {
    const int lo = q0 - window - BN + 2;   // first live k_start
    if (lo > 0) t_lo = (lo + BN - 1) / BN;
  }
  const int n_tiles = max(t_hi - t_lo, 0);

  // Q tile; rows past S are zeros, never stored
  for (int i = tid; i < BM * CPR; i += THREADS) {
    const int r = i / CPR;
    const int c = i - r * CPR;
    const bool in = q0 + r < S;
    if constexpr (PAD)
      cp_async16_part(qs + r * ROW + c * 8, qh + (size_t)(q0 + r) * d, c,
                      d * 2, in, qh);
    else
      cp_async16(smem_addr(qs + r * ROW + c * 8),
                 in ? qh + (size_t)(q0 + r) * D + c * 8 : qh, in ? 16 : 0);
  }

  // key tile t into ring stage `stage`; keys past Sk are zero-filled
  auto load_tile = [&](int t, int stage) {
    const int k0 = t * BN;
    __nv_bfloat16* kd = k_ring + stage * BN * ROW;
    __nv_bfloat16* vd = v_ring + stage * BN * ROW;
    for (int i = tid; i < BN * CPR; i += THREADS) {
      const int j = i / CPR;
      const int c = i - j * CPR;
      const bool in = k0 + j < Sk;
      if constexpr (PAD) {
        const size_t row = (size_t)(k0 + j) * d;
        cp_async16_part(kd + j * ROW + c * 8, kh + row, c, d * 2, in, kh);
        cp_async16_part(vd + j * ROW + c * 8, vh + row, c, d * 2, in, vh);
      } else {
        const size_t off = in ? (size_t)(k0 + j) * D + c * 8 : 0;
        cp_async16(smem_addr(kd + j * ROW + c * 8), kh + off, in ? 16 : 0);
        cp_async16(smem_addr(vd + j * ROW + c * 8), vh + off, in ? 16 : 0);
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

  const int slab = WIDE ? warp / NS : warp;
  const int slice = WIDE ? warp % NS : 0;
  const int c0 = slice * SW;            // the warp's first column
  const int row0 = slab * 16;           // the warp's 16-row slab
  const int g = lane >> 2;              // the thread's rows: row0 + g, + 8
  const int t4 = lane & 3;              // and columns 2 * t4, + 1 of each tile
  const int r_lo = q0 + row0;           // the slab's first and last rows
  const int r_hi = r_lo + 15;
  const int pos0 = r_lo + g;
  const int pos1 = pos0 + 8;

  float m[2] = {kNegInf, kNegInf};      // running max, log2 domain
  float l[2] = {0.f, 0.f};              // this thread's share of the row sums
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  uint32_t qf[KT][4];                   // the slab's Q fragments

  for (int i = 0; i < n_tiles; ++i) {
    const int t = t_lo + i;
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t has landed; the stage of tile t - 1 is free
    if (i + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1, (i + STAGES - 1) % STAGES);
    cp_async_commit();
    if (i == 0) {   // Q landed with the first tile: its fragments, once
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        ldsm4(smem_addr(qs + (row0 + (lane & 15)) * ROW + c0 + kk * 16 +
                        (lane >> 4) * 8),
              qf[kk]);
    }
    const int stage = i % STAGES;

    // the tile's keys in steps of STEP: the same steps, in the same order,
    // whatever BN, so every tile gives the same bits
#pragma unroll 1
    for (int st = 0; st < BN / SK; ++st) {
      // a step none of whose keys the warp's slab sees is skipped
      const int k_lo = t * BN + st * SK;
      const int k_hi = k_lo + SK - 1;
      if (k_lo >= Sk || (causal && k_lo > r_hi) ||
          (window > 0 && r_lo - k_hi >= window))
        continue;
      const bool need_mask = k_hi >= Sk || (causal && k_hi > r_lo) ||
                             (window > 0 && r_hi - k_lo >= window);
      const __nv_bfloat16* kt = k_ring + (stage * BN + st * SK) * ROW;
      const __nv_bfloat16* vt = v_ring + (stage * BN + st * SK) * ROW;

      // S = Q K^T for the slab's 16 rows and the step's keys
      float s[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bk[4];
          const int key = np * 16 + (lane & 7) + ((lane >> 4) << 3);
          const int col = c0 + kk * 16 + (((lane >> 3) & 1) << 3);
          ldsm4(smem_addr(kt + key * ROW + col), bk);
          mma16816(s[2 * np], qf[kk], bk[0], bk[1]);
          mma16816(s[2 * np + 1], qf[kk], bk[2], bk[3]);
        }
      }
      // the wide instances: the slab's slices' partials summed in slice
      // order (one step a tile: the next tile's block barrier frees them)
      if constexpr (WIDE) {
        float* sp = reinterpret_cast<float*>(tc_smem + L::sp_off);
        sum_slices<NS, NT>(s, sp + slab * NS * NT * 128, slice, lane,
                           1 + slab);
      }

      // scale, mask, online softmax in fp32
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * scale_log2;
          if (need_mask) {
            const int key = k_lo + n * 8 + 2 * t4 + (e & 1);
            const int pos = e < 2 ? pos0 : pos1;
            if (key >= Sk || (causal && key > pos) ||
                (window > 0 && pos - key >= window))
              x = kNegInf;
          }
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

      // P in bf16 as the A operand of P.V
      uint32_t pa[NT / 2][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float p0 = exp2f(s[n][0] - mx[0]);
        const float p1 = exp2f(s[n][1] - mx[0]);
        const float p2 = exp2f(s[n][2] - mx[1]);
        const float p3 = exp2f(s[n][3] - mx[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pa[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
        pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
      }

      // O += P V
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
        for (int dp = 0; dp < SW / 16; ++dp) {
          uint32_t bv[4];
          const int key = kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3);
          const int col = c0 + dp * 16 + ((lane >> 4) << 3);
          ldsm4_trans(smem_addr(vt + key * ROW + col), bv);
          mma16816(acc[2 * dp], pa[kk], bv[0], bv[1]);
          mma16816(acc[2 * dp + 1], pa[kk], bv[2], bv[3]);
        }
      }
    }
  }
  // normalise and store the rows below S
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
    const int qi = q0 + row0 + g + 8 * r;
    if (qi >= S) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    __nv_bfloat16* dst = o + (((size_t)b * H + h) * S + qi) * d + c0 + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      if constexpr (PAD) {     // the columns below d, one at a time
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

// ---------------------------------------------------------------------------
// K2: decode, q (B, H, 1, D), caches (B, Hkv, S, D), kv_len (B,) int32.
// ---------------------------------------------------------------------------

namespace k2 {
constexpr int BK = 32;             // keys per warp tile: lane j owns key j
constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
}  // namespace k2

template <typename T, int D, int GR, bool PAD>
__global__ void __launch_bounds__(k2::THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    T* __restrict__ o, int H, int Hkv, int S, float scale,
                    int d_run) {
  using namespace k2;
  const int d = PAD ? d_run : D;          // the row stride (common.cuh)
  constexpr int NC = (D + 31) / 32;       // contiguous columns per lane
  constexpr int VN = 16 / sizeof(T);      // elements per 16-byte load
  __shared__ __align__(16) float qs[GR * D];
  __shared__ float ms[NWARPS][GR];
  __shared__ float ls[NWARPS][GR];
  __shared__ __align__(16) float accs[NWARPS][GR][D];

  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x - b * Hkv;
  const int h0 = hk * (H / Hkv) + blockIdx.y * GR;  // first query row's head
  const size_t qoff = ((size_t)b * H + h0) * d;
  const size_t koff = ((size_t)b * Hkv + hk) * S * d;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < GR * D; i += THREADS) {
    if constexpr (PAD) {
      const int c = i % D;
      qs[i] = c < d ? to_float(q[qoff + (size_t)(i / D) * d + c]) : 0.f;
    } else {
      qs[i] = to_float(q[qoff + i]);
    }
  }
  __syncthreads();
  const int len = min(max(kv_len[b], 0), S);

  float m[GR], l[GR], acc[GR][NC];
#pragma unroll
  for (int g = 0; g < GR; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[g][c] = 0.f;
  }

  for (int t = warp; t * BK < len; t += NWARPS) {
    const int j = t * BK + lane;
    const bool live = j < len;
    float s[GR];
#pragma unroll
    for (int g = 0; g < GR; ++g) s[g] = 0.f;
    if (live) {
      const T* kr = k + koff + (size_t)j * d;
#pragma unroll 4
      for (int c = 0; c < D; c += VN) {
        float kf[VN];
        if constexpr (PAD) {
#pragma unroll
          for (int e = 0; e < VN; ++e)
            kf[e] = c + e < d ? to_float(kr[c + e]) : 0.f;
        } else {
          load_f32<VN>(kr + c, kf);
        }
#pragma unroll
        for (int g = 0; g < GR; ++g)
#pragma unroll
          for (int e = 0; e < VN; e += 4) {
            const float4 qv = *reinterpret_cast<const float4*>(qs + g * D + c + e);
            s[g] += qv.x * kf[e] + qv.y * kf[e + 1] + qv.z * kf[e + 2] +
                    qv.w * kf[e + 3];
          }
      }
    }

    float p[GR];
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      const float x = live ? s[g] * scale : kNegInf;
      const float m_cur = fmaxf(m[g], warp_max(x));
      p[g] = expf(x - m_cur);
      const float alpha = expf(m[g] - m_cur);
      l[g] = l[g] * alpha + warp_sum(p[g]);
      m[g] = m_cur;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[g][c] *= alpha;
    }

    const int n = min(BK, len - t * BK);
    const T* vb = v + koff + (size_t)t * BK * d + lane * NC;
    for (int jj = 0; jj < n; ++jj) {
      float vv[NC];
      if constexpr (PAD) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
          vv[c] = lane * NC + c < d ? to_float(vb[(size_t)jj * d + c]) : 0.f;
      } else if (lane * NC < D) {
        load_f32<NC>(vb + (size_t)jj * D, vv);
      } else {
#pragma unroll
        for (int c = 0; c < NC; ++c) vv[c] = 0.f;
      }
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        const float pj = __shfl_sync(kFull, p[g], jj);
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[g][c] += pj * vv[c];
      }
    }
  }

  // merge the warps' partial states: m* = max m_w, l* = sum l_w e^(m_w-m*)
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GR; ++g) {
      ms[warp][g] = m[g];
      ls[warp][g] = l[g];
    }
  }
  if (lane * NC < D) {
#pragma unroll
    for (int g = 0; g < GR; ++g)
#pragma unroll
      for (int c = 0; c < NC; ++c) accs[warp][g][lane * NC + c] = acc[g][c];
  }
  __syncthreads();
  for (int i = tid; i < GR * D; i += THREADS) {
    const int g = i / D;
    const int dd = i - g * D;
    float m_star = kNegInf;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) m_star = fmaxf(m_star, ms[w][g]);
    float l_star = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float e = expf(ms[w][g] - m_star);
      l_star += ls[w][g] * e;
      a += accs[w][g][dd] * e;
    }
    const float out = a / (l_star == 0.f ? 1.f : l_star);
    if constexpr (PAD) {
      if (dd < d) o[qoff + (size_t)g * d + dd] = from_float<T>(out);
    } else {
      o[qoff + i] = from_float<T>(out);
    }
  }
}

// ---------------------------------------------------------------------------
// host-side launchers.  PAD instances take the head dim d as an argument
// (the row stride; d <= D, the instance's width); the others are built for
// d = D and ignore it.
// ---------------------------------------------------------------------------

template <typename T, int D, bool PAD>
cudaError_t launch_attention(const void* q, const void* k, const void* v,
                             void* o, int B, int H, int Hkv, int S, int Sk,
                             int causal, int window, float scale, int d,
                             cudaStream_t stream) {
  constexpr size_t smem = k1::smem_bytes<D>();
  constexpr int BQ = k1::bq<D>();
  auto kern = flash_attention_kernel<T, D, PAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, k1::threads<D>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, S, Sk, causal,
      window, scale, d);
  return cudaGetLastError();
}

template <typename T, int D, int GR, bool PAD>
cudaError_t launch_decode_gr(const void* q, const void* k, const void* v,
                             const int* kv_len, void* o, int B, int H,
                             int Hkv, int S, float scale, int d,
                             cudaStream_t stream) {
  const dim3 grid(B * Hkv, (H / Hkv) / GR);
  flash_decode_kernel<T, D, GR, PAD><<<grid, k2::THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(o), H, Hkv, S,
      scale, d);
  return cudaGetLastError();
}

template <typename T, int D, bool PAD>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int* kv_len, void* o, int B, int H, int Hkv,
                          int S, float scale, int d, cudaStream_t stream) {
  // rows per block: the largest of 8, 4, 2, 1 dividing the group size G;
  // a padded instance's largest is 4, and a wide one's (D > 256) 2, so
  // that its static shared memory (qs and the warps' accs, 36 KB at D =
  // 256 and 4 rows, 36.9 KB at D = 512 and 2; 48-80 registers) stays under
  // 48 KB
  const int G = H / Hkv;
  if constexpr (!PAD) {
    if (G % 8 == 0)
      return launch_decode_gr<T, D, 8, PAD>(q, k, v, kv_len, o, B, H, Hkv, S, scale, d, stream);
  }
  if constexpr (D <= 256) {
    if (G % 4 == 0)
      return launch_decode_gr<T, D, 4, PAD>(q, k, v, kv_len, o, B, H, Hkv, S,
                                            scale, d, stream);
  }
  if (G % 2 == 0)
    return launch_decode_gr<T, D, 2, PAD>(q, k, v, kv_len, o, B, H, Hkv, S, scale, d, stream);
  return launch_decode_gr<T, D, 1, PAD>(q, k, v, kv_len, o, B, H, Hkv, S, scale, d, stream);
}

// f(Int<BM>, Int<BN>) for the instantiated K1 tile of bm query rows and
// bn keys at head dim D, else cudaErrorInvalidValue: rows 64 and 128 by
// keys 64 and 128 at the head dims of the archs the card serves, 128,
// h2o-danube-1.8b's 80, zamba2-7b's 112 and pixtral-12b's 160
// (ops.attention hands K1 the
// tile FlashBlocks published whatever the head dim), the default 64 x 64
// at the others and at every padded instance up to 256; a wide instance
// (D > 256) has 32 x 32 alone.
template <int D, bool PAD, typename F>
cudaError_t k1_with_tile(int bm, int bn, F&& f) {
  if constexpr (D > 256) {
    if (bm == k1tc::WIDE_BM && bn == k1tc::WIDE_BN)
      return f(Int<k1tc::WIDE_BM>{}, Int<k1tc::WIDE_BN>{});
    return cudaErrorInvalidValue;
  } else {
    if (bm == k1tc::DEFAULT_BM && bn == k1tc::DEFAULT_BN)
      return f(Int<k1tc::DEFAULT_BM>{}, Int<k1tc::DEFAULT_BN>{});
    if constexpr (!PAD && (D == 128 || D == 80 || D == 112 || D == 160)) {
      if ((bm == 64 || bm == 128) && (bn == 64 || bn == 128)) {
        auto keys = [&](auto rows) {
          return bn == 64 ? f(rows, Int<64>{}) : f(rows, Int<128>{});
        };
        return bm == 64 ? keys(Int<64>{}) : keys(Int<128>{});
      }
    }
    return cudaErrorInvalidValue;
  }
}

template <int D, int BM, int BN, bool PAD>
cudaError_t launch_attention_tc(const void* q, const void* k, const void* v,
                                void* o, int B, int H, int Hkv, int S,
                                int Sk, int causal, int window, float scale,
                                int d, cudaStream_t stream) {
  constexpr size_t smem = k1tc::Smem<D, BM, BN>::bytes;
  auto kern = flash_attention_tc_kernel<D, BM, BN, PAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BM - 1) / BM, H, B);
  kern<<<grid, k1tc::threads<D, BM, BN>(), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, Hkv, S, Sk, causal, window, scale * kLog2e, d);
  return cudaGetLastError();
}

template <int D, int BM, int BN, bool PAD>
cudaError_t attention_tc_info(int* out) {
  return instance_info(flash_attention_tc_kernel<D, BM, BN, PAD>,
                       k1tc::threads<D, BM, BN>(),
                       k1tc::Smem<D, BM, BN>::bytes, out);
}

// f(Int<D>, pad) for the instance of head dim d: with dp = 0 the head
// dim's own (K1 and the float32 K2's SIMT templates are built for D = 16,
// 32, 64 and 128, K1 also for h2o-danube-1.8b's 80, zamba2-7b's 112 and
// pixtral-12b's 160), else the padded instance of width dp (common.cuh's
// with_pad_width)
template <bool DECODE, typename F>
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
    }
    if constexpr (!DECODE) {
      switch (d) {
        case 80: return f(Int<80>{}, own);
        case 112: return f(Int<112>{}, own);
        case 160: return f(Int<160>{}, own);
      }
    }
    return cudaErrorInvalidValue;
  }
}

// K1 over float32 (T = float, the SIMT template, whose one tile is
// k1::BQ x k1::BK; block_q and block_k are not read) or bf16 (T =
// __nv_bfloat16, the tensor cores at the tile block_q x block_k)
template <typename T>
cudaError_t attention_by_dim(const void* q, const void* k, const void* v,
                             void* o, int B, int H, int Hkv, int S, int Sk,
                             int D, int dp, int causal, int window,
                             float scale, int block_q, int block_k,
                             cudaStream_t st) {
  return with_dim<false>(D, dp, [&](auto w, auto pad) {
    constexpr int DD = decltype(w)::value;
    constexpr bool PAD = decltype(pad)::value;
    if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      return k1_with_tile<DD, PAD>(block_q, block_k, [&](auto bm, auto bn) {
        return launch_attention_tc<DD, decltype(bm)::value,
                                   decltype(bn)::value, PAD>(
            q, k, v, o, B, H, Hkv, S, Sk, causal, window, scale, D, st);
      });
    } else {
      return launch_attention<T, DD, PAD>(q, k, v, o, B, H, Hkv, S, Sk,
                                          causal, window, scale, D, st);
    }
  });
}

// The float32 K2: a lane owns D / 32 contiguous columns of a V row (NC), so
// its own instances are at D = 16, 32, 64 and 128; h2o-danube-1.8b's 80,
// zamba2-7b's 112 and pixtral-12b's 160 (and every other head dim) run on
// the padded instances (96, 128, 160: 3, 4, 5 columns a lane, those at
// and past d zero).  A bf16 query runs paged_decode.cu's dense mode.
template <typename T>
cudaError_t decode_by_dim(const void* q, const void* k, const void* v,
                          const int* kv_len, void* o, int B, int H, int Hkv,
                          int S, int D, int dp, float scale,
                          cudaStream_t st) {
  return with_dim<true>(D, dp, [&](auto w, auto pad) {
    return launch_decode<T, decltype(w)::value, decltype(pad)::value>(
        q, k, v, kv_len, o, B, H, Hkv, S, scale, D, st);
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (K1 of bfloat16 runs on the tensor
// cores at the tile of block_q query rows and block_k keys, which must
// have an instance (see k1_with_tile), of float32 on the SIMT template,
// which reads no tile).  dp: 0 for the head dim D's own instance, else the
// width of the padded instance to run (kernels/flash_attention.py's
// route()).  window <= 0 means no sliding window.  S query
// rows attend to Sk keys; Sk != S only without a causal mask or a window
// (cross attention), else cudaErrorInvalidValue.
// Returns the launch's cudaError_t (0 = success; a tile or head dim without
// an instance returns cudaErrorInvalidValue and launches nothing).  The
// caller validates shapes, contiguity and alignment; the kernels never
// allocate or sync.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int Hkv, int S, int Sk, int D, int dp,
                                     int dtype, int causal, int window,
                                     float scale, int block_q, int block_k,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || Sk < 1 || (Sk != S && (causal || window > 0)))
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return attention_by_dim<float>(q, k, v, o, B, H, Hkv, S, Sk, D, dp,
                                   causal, window, scale, block_q, block_k,
                                   st);
  if (dtype == 1)
    return attention_by_dim<__nv_bfloat16>(q, k, v, o, B, H, Hkv, S, Sk, D,
                                           dp, causal, window, scale,
                                           block_q, block_k, st);
  return cudaErrorInvalidValue;
}

extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* kv_len, void* o, int B, int H,
                                  int Hkv, int S, int D, int dp, int dtype,
                                  float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_len);
  if (dtype == 0)   // bf16: paged_decode.cu's repro_flash_decode_tc
    return decode_by_dim<float>(q, k, v, lens, o, B, H, Hkv, S, D, dp, scale,
                                st);
  return cudaErrorInvalidValue;
}

// The bf16 K1 instance for head dim D (dp as repro_flash_attention's) at
// the tile of block_q query rows and block_k keys: out[0..3] = registers
// per thread, local-memory (spill) bytes, dynamic shared memory in bytes,
// resident blocks per SM.
extern "C" int repro_flash_attention_tc_info(int D, int dp, int block_q,
                                             int block_k, int* out) {
  return with_dim<false>(D, dp, [&](auto w, auto pad) {
    constexpr int DD = decltype(w)::value;
    constexpr bool PAD = decltype(pad)::value;
    return k1_with_tile<DD, PAD>(block_q, block_k, [&](auto bm, auto bn) {
      return attention_tc_info<DD, decltype(bm)::value, decltype(bn)::value,
                               PAD>(out);
    });
  });
}
