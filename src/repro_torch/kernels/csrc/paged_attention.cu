// Paged attention for Hopper (sm_90a): one-token decode and chunked
// prefill against K/V page pools (P, Hkv, psz, D) shared by every sequence,
// each sequence reaching its pages through a row of a page table (B, nblk)
// int32; split-KV decode with its combine; the same kernels over int8
// pools with per-row fp32 scales.  Plain C interface, bound from Python
// with ctypes (kernels/paged_attention.py); no PyTorch headers.
//
// Each kernel replaces a Pallas kernel of src/repro/kernels/flash_attention.py:
// K3  paged_decode_kernel<float, normalise> flash_paged_decode /
//                                          _paged_decode_kernel (num_splits=1),
//                                          float32 query only
// K5a paged_decode_kernel<float, partials> _paged_decode_split_kernel,
//                                          float32 query only
// K5c split_combine_kernel                 _combine_splits /
//                                          _split_combine_kernel
// K6a paged_decode_kernel<float, int8, normalise> flash_paged_decode_quant /
//                                          _paged_decode_quant_kernel,
//                                          float32 query only
// K6b paged_decode_kernel<float, int8, partials>
//                                          _paged_decode_split_quant_kernel,
//                                          float32 query only
// K4  paged_prefill_kernel<float, one pass>       flash_paged_prefill /
//                                          _paged_prefill_kernel (num_splits=1),
//                                          float32 query only
// K5b paged_prefill_kernel<float, partials> _paged_prefill_split_kernel,
//                                          float32 query only
// K6c paged_prefill_kernel<float, int8, one pass> flash_paged_prefill_quant /
//                                          _paged_prefill_quant_kernel,
//                                          float32 query only
// K6d paged_prefill_kernel<float, int8, partials>
//                                          _paged_prefill_split_quant_kernel,
//                                          float32 query only
// With a bf16 query, the main path, K3, K6a, K5a and K6b run in
// paged_decode.cu (a thread-block cluster per lane and kv head, cp.async
// row copies, tensor cores; K5a and K6b as its partials mode) and K4, K5b,
// K6c and K6d on the tensor cores in paged_prefill.cu; their instances
// here take float32 only (a TF32 product would break the fp32 tolerance).
//
// Semantics kept from the TPU kernels: key j of sequence b lives in page
// table[b, j / psz] at slot j % psz; only keys j < kv_len[b] are read (table
// entries past ceil(kv_len / psz) are never read, so they may point
// anywhere, page 0 by convention); inputs are upcast to fp32 before every
// product, the online softmax runs in fp32 with -1e30 masking, and a row
// that sees no key (kv_len == 0) yields exactly 0.  GQA maps query head h
// to kv head h / (H / Hkv).  Any page size works: addresses are computed
// per key row, so a 32-key tile may span several pages.  An int8 pool's row
// (page, head, slot) has the scale scale[(page * Hkv + head) * psz + slot];
// a key or value element is dequantised as float(code) * scale right where
// it is loaded, so device-memory traffic is the int8 bytes.
//
// What bounds them on an H100.  All are memory-bound at the serving
// shapes: a decode step must read every live K/V row once (4.2 MB of bf16
// at four yi-6b lanes of ~520 tokens, half that in int8), a prefill chunk
// reads its Q and the committed K/V prefix once.  These versions keep the
// structure of K2 and K1, SIMT fp32 products from shared memory:
//  * decode (K3/K6a/K5a/K6b with a float32 query; a bf16 query's are
//    paged_decode.cu's): one block of 8 warps per
//    (lane, kv head[, split]) holding the G grouped query rows, so each K/V
//    row is read from device memory once for all G rows.  The block stages the lane's live page-table entries
//    in shared memory once; each lane of a warp owns one key of a 32-key
//    tile, finds its row through the staged table, and the warps split the
//    tiles and merge their (m, l, acc) states by a max-shift in shared
//    memory.  The row a lane found is broadcast by a shuffle to the value
//    pass.  With one block per (lane, kv head), four yi-6b lanes give 16
//    blocks for 132 SMs; split-KV (K5a/K6b) adds a grid axis of ns splits,
//    each walking its own contiguous range of the lane's LIVE key tiles
//    (ceil(ceil(kv_len / 32) / ns) tiles each), and writes its unnormalised
//    (m, l, acc) to fp32 partials (B, Hkv, ns, G[, D]); an empty split
//    writes (-1e30, 0, 0).  K5c merges them: one block per (lane x kv head,
//    query row), one thread per column.
//  * prefill: one block of 4 warps per (sequence, head, 64-row query tile);
//    query row i sits at absolute position start[b] + i.  K/V tiles of 32
//    keys are staged in shared memory as fp32 (rows padded to D + 1), each
//    row fetched through the table and dequantised on the way in for int8
//    pools; a tile is skipped when it starts at or past kv_len or past the
//    tile's last query.  Rows past the chunk are padding: loaded as 0,
//    never stored.  Split prefill/verify (K5b/K6d) folds the split into
//    the grid's x axis (q_tile * ns + split, as the TPU kernel folds rows
//    at iq * ns + isp); split s walks the contiguous share [s * per,
//    min((s + 1) * per, t_hi)) of the block's live tiles, per = ceil(t_hi
//    / ns), and writes fp32 partials m, l (B, H, ns, C) and acc (B, H,
//    ns, C, D) for the chunk's C rows only (not the padded 64-row tile:
//    a 5-row verify chunk writes 5 rows), merged by K5c.  A split with
//    no tile, or a row that sees no key of its split, writes (-1e30, 0,
//    0).  What bounds split verify: the K/V walk of the lane's prefix
//    (one 32-key tile's load latency per tile and warp); the split cuts
//    the tiles each block walks by ns, for ns blocks per (head, q tile)
//    and a partials round trip of C rows.
//    Tensor cores and asynchronous copies: paged_prefill.cu.

#include "common.cuh"

namespace {

// index of key j's row for kv head hk, through the staged table: the row
// pool[tbl[j / psz], hk, j % psz, :] starts at element row * D, and an
// int8 pool's scale of that row is scale[row]
__device__ __forceinline__ size_t row_index(const int* tbl, int j, int hk,
                                            int Hkv, int psz) {
  const int blk = j / psz;
  return ((size_t)tbl[blk] * Hkv + hk) * psz + (j - blk * psz);
}

// ---------------------------------------------------------------------------
// K3 / K5a / K6a / K6b: paged decode, q (B, H, 1, D) of type T, pools
// (P, Hkv, psz, D) of type S (T, or int8_t with scales (P, Hkv, psz)),
// table (B, nblk), kv_len (B,) int32.  SPLIT = false: normalise and store o
// (B, H, 1, D); SPLIT = true: blockIdx.z is the split, partials m, l
// (B, Hkv, ns, G) and acc (B, Hkv, ns, G, D) fp32.  Dynamic shared memory:
// the lane's live table entries.
// ---------------------------------------------------------------------------

namespace k3 {
constexpr int BK = 32;             // keys per warp tile: lane j owns key j
constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
}  // namespace k3

template <typename T, typename S, int D, int GR, bool SPLIT, bool PAD>
__global__ void __launch_bounds__(k3::THREADS)
paged_decode_kernel(const T* __restrict__ q, const S* __restrict__ kp,
                    const S* __restrict__ vp, const float* __restrict__ ksc,
                    const float* __restrict__ vsc,
                    const int* __restrict__ table,
                    const int* __restrict__ kv_len, T* __restrict__ o,
                    float* __restrict__ pm, float* __restrict__ pl,
                    float* __restrict__ pacc, int H, int Hkv, int psz,
                    int nblk, float scale, int d_run) {
  using namespace k3;
  const int d = PAD ? d_run : D;          // the row stride (common.cuh)
  constexpr bool QUANT = std::is_same_v<S, int8_t>;
  constexpr int NC = (D + 31) / 32;       // contiguous columns per lane
  constexpr int VN = 16 / sizeof(S);      // elements per 16-byte load
  extern __shared__ int tbl[];            // the lane's live table entries
  __shared__ __align__(16) float qs[GR * D];
  __shared__ float ms[NWARPS][GR];
  __shared__ float ls[NWARPS][GR];
  __shared__ __align__(16) float accs[NWARPS][GR][D];

  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x - b * Hkv;
  const int h0 = hk * (H / Hkv) + blockIdx.y * GR;  // first query row's head
  const size_t qoff = ((size_t)b * H + h0) * d;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int len = min(max(kv_len[b], 0), nblk * psz);
  const int n_live = (len + psz - 1) / psz;
  // the key tiles this block walks: all of the lane's live tiles, or the
  // split's contiguous share of them
  int t_lo = 0, t_hi = (len + BK - 1) / BK;
  if constexpr (SPLIT) {
    const int per = (t_hi + (int)gridDim.z - 1) / (int)gridDim.z;
    t_lo = blockIdx.z * per;
    t_hi = min(t_hi, t_lo + per);
  }
  for (int i = tid; i < n_live; i += THREADS) tbl[i] = table[(size_t)b * nblk + i];
  for (int i = tid; i < GR * D; i += THREADS) {
    if constexpr (PAD) {
      const int c = i % D;
      qs[i] = c < d ? to_float(q[qoff + (size_t)(i / D) * d + c]) : 0.f;
    } else {
      qs[i] = to_float(q[qoff + i]);
    }
  }
  __syncthreads();

  float m[GR], l[GR], acc[GR][NC];
#pragma unroll
  for (int g = 0; g < GR; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[g][c] = 0.f;
  }

  for (int t = t_lo + warp; t < t_hi; t += NWARPS) {
    const int j = t * BK + lane;
    const bool live = j < len;
    const unsigned long long row =
        live ? row_index(tbl, j, hk, Hkv, psz) : 0ull;
    float k_scale = 1.f, v_scale = 0.f;   // this lane's key row's scales
    if constexpr (QUANT) {
      if (live) {
        k_scale = ksc[row];
        v_scale = vsc[row];
      }
    }
    float s[GR];
#pragma unroll
    for (int g = 0; g < GR; ++g) s[g] = 0.f;
    if (live) {
      const S* kr = kp + row * d;
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
        if constexpr (QUANT) {
#pragma unroll
          for (int e = 0; e < VN; ++e) kf[e] *= k_scale;
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
    for (int jj = 0; jj < n; ++jj) {
      const unsigned long long vo = __shfl_sync(kFull, row, jj) * d;
      float vs = 1.f;
      if constexpr (QUANT) vs = __shfl_sync(kFull, v_scale, jj);
      float vv[NC];
      if constexpr (PAD) {
#pragma unroll
        for (int c = 0; c < NC; ++c)
          vv[c] = lane * NC + c < d ? to_float(vp[vo + lane * NC + c]) * vs
                                    : 0.f;
      } else if (lane * NC < D) {
        load_f32<NC>(vp + vo + lane * NC, vv);
        if constexpr (QUANT) {
#pragma unroll
          for (int c = 0; c < NC; ++c) vv[c] *= vs;
        }
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
    if (PAD && dd >= d) continue;
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
    if constexpr (SPLIT) {
      // unnormalised state of (b, hk, split, row): an empty split leaves
      // m* = -1e30, l* = 0, acc* = 0
      const int G = H / Hkv;
      const size_t prow =
          ((size_t)blockIdx.x * gridDim.z + blockIdx.z) * G + blockIdx.y * GR + g;
      pacc[prow * d + dd] = a;
      if (dd == 0) {
        pm[prow] = m_star;
        pl[prow] = l_star;
      }
    } else if constexpr (PAD) {
      o[qoff + (size_t)g * d + dd] =
          from_float<T>(a / (l_star == 0.f ? 1.f : l_star));
    } else {
      o[qoff + i] = from_float<T>(a / (l_star == 0.f ? 1.f : l_star));
    }
  }
}

// ---------------------------------------------------------------------------
// K5c: merge split partials m, l (BR, ns, rows) and acc (BR, ns, rows, D)
// fp32 into o (BR, rows, D) of type T.  One block per (br, row), one thread
// per column.  A row whose splits are all empty gives exactly 0.  The steps
// are common.cuh's split_alpha / split_fma / split_out, which the merge in
// the epilogue of the bf16 split phase-1 kernels (paged_decode.cu,
// paged_prefill.cu) shares, so that route is bit-equal to this one over
// the same partials.  Since that merge, this kernel serves a float32 query.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void split_combine_kernel(const float* __restrict__ pm,
                                     const float* __restrict__ pl,
                                     const float* __restrict__ pacc,
                                     T* __restrict__ o, int ns, int rows,
                                     int D) {
  const int br = blockIdx.x;
  const int r = blockIdx.y;
  const int d = threadIdx.x;
  const size_t base = (size_t)br * ns * rows + r;   // split s at base + s*rows
  float m_star = kNegInf;
  for (int s = 0; s < ns; ++s) m_star = fmaxf(m_star, pm[base + (size_t)s * rows]);
  float l_star = 0.f, a = 0.f;
  for (int s = 0; s < ns; ++s) {
    const size_t i = base + (size_t)s * rows;
    const float alpha = split_alpha(pm[i], m_star);
    l_star = split_fma(l_star, pl[i], alpha);
    a = split_fma(a, pacc[i * D + d], alpha);
  }
  o[((size_t)br * rows + r) * D + d] = from_float<T>(split_out(a, l_star));
}

// ---------------------------------------------------------------------------
// K4 / K5b / K6c / K6d: paged chunked prefill, q (B, H, C, D) of type T,
// pools (P, Hkv, psz, D) of type S (T, or int8_t with scales (P, Hkv,
// psz)), table (B, nblk), start and kv_len (B,) int32.  SPLIT = false:
// normalise and store o like q; SPLIT = true: blockIdx.x = q_tile * ns +
// split, partials m, l (B, H, ns, C) and acc (B, H, ns, C, D) fp32.
// ---------------------------------------------------------------------------

namespace k4 {
constexpr int BQ = 64;             // query rows per block
constexpr int BK = 32;             // keys per tile: lane j owns key j
constexpr int NWARPS = 4;
constexpr int THREADS = NWARPS * 32;
constexpr int RPW = BQ / NWARPS;   // query rows per warp

// The wide instances (D > 256) take 32 chunk rows in 8 warps, 4 rows a
// warp, as flash_attention.cu's float32 K1 does: a lane's O is 4 x D / 32
// fp32, and the block's shared memory 200,832 B at D = 512 (151,680 at
// 384), where 64 rows would need 270,464.  One block an SM (ptxas:
// 127-224 registers; the split instances at 384 spill 20 B).
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
}  // namespace k4

template <typename T, typename S, int D, bool SPLIT, bool PAD>
__global__ void __launch_bounds__(k4::threads<D>())
paged_prefill_kernel(const T* __restrict__ q, const S* __restrict__ kp,
                     const S* __restrict__ vp, const float* __restrict__ ksc,
                     const float* __restrict__ vsc,
                     const int* __restrict__ table,
                     const int* __restrict__ start,
                     const int* __restrict__ kv_len, T* __restrict__ o,
                     float* __restrict__ pm, float* __restrict__ pl,
                     float* __restrict__ pacc, int H, int Hkv, int C,
                     int psz, int nblk, int ns, float scale, int d_run) {
  using namespace k4;
  constexpr int BQ = bq<D>();        // chunk rows per block
  constexpr int THREADS = threads<D>();
  constexpr int RPW = BQ / nwarps<D>();   // chunk rows per warp
  const int d = PAD ? d_run : D;     // the row stride (common.cuh)
  constexpr bool QUANT = std::is_same_v<S, int8_t>;
  constexpr int NC = (D + 31) / 32;  // output columns per lane
  constexpr int KS = D + 1;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + BQ * D;
  float* vs = ks + BK * KS;
  float* ps = vs + BK * D;
  __shared__ size_t roffs[BK];       // the tile's key rows in the pools
  __shared__ float k_scales[BK];     // and their scales (int8 pools)
  __shared__ float v_scales[BK];

  // the q tile and, split, which share of its key tiles this block walks
  const int tile = SPLIT ? blockIdx.x / ns : blockIdx.x;
  const int split = SPLIT ? blockIdx.x - tile * ns : 0;
  const int i0 = tile * BQ;          // first chunk row of the tile
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t qoff = ((size_t)b * H + h) * C * d;
  const int* tbl = table + (size_t)b * nblk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * RPW;
  const int len = min(max(kv_len[b], 0), nblk * psz);
  const int q_start = start[b] + i0;   // absolute position of row i0

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int qi = i0 + i / D;
    if constexpr (PAD) {
      const int c = i % D;
      qs[i] = qi < C && c < d ? to_float(q[qoff + (size_t)qi * d + c]) : 0.f;
    } else {
      qs[i] = qi < C ? to_float(q[qoff + (size_t)i0 * D + i]) : 0.f;
    }
  }

  // live key tiles: committed (k_start < kv_len) and causally visible to
  // the tile's last query (k_start <= q_start + BQ - 1)
  const int last = q_start + BQ - 1;
  int t_lo = 0;
  int t_hi = last < 0 ? 0 : min((len + BK - 1) / BK, last / BK + 1);
  if constexpr (SPLIT) {
    const int per = (t_hi + ns - 1) / ns;
    t_lo = min(split * per, t_hi);
    t_hi = min(t_hi, t_lo + per);
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
    if (tid < BK) {
      const int kj = k_start + tid;
      const size_t row = kj < len ? row_index(tbl, kj, hk, Hkv, psz) : 0;
      roffs[tid] = row * d;
      if constexpr (QUANT) {
        k_scales[tid] = kj < len ? ksc[row] : 0.f;
        v_scales[tid] = kj < len ? vsc[row] : 0.f;
      }
    }
    __syncthreads();
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D;
      const int c = i - j * D;
      const bool in = k_start + j < len && (!PAD || c < d);
      const size_t g = roffs[j] + c;
      float kf = in ? to_float(kp[g]) : 0.f;
      float vf = in ? to_float(vp[g]) : 0.f;
      if constexpr (QUANT) {
        kf *= k_scales[j];
        vf *= v_scales[j];
      }
      ks[j * KS + c] = kf;
      vs[i] = vf;
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
      const bool live = kj < len && kj <= qi;
      const float x = live ? s[r] * scale : kNegInf;
      const float m_cur = fmaxf(m[r], warp_max(x));
      // a split may start past a row's last visible key: with nothing
      // seen, m_cur is -1e30 and exp(x - m_cur) would weigh masked keys
      // 1, so split partials weigh them 0 (from tile 0 on, key 0 is
      // visible to every row, and the one-pass kernel never meets this)
      float p;
      if constexpr (SPLIT) p = live ? expf(x - m_cur) : 0.f;
      else p = expf(x - m_cur);
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
    const int i = i0 + r0 + r;
    if (i >= C) continue;              // padding of the last q tile
    if constexpr (SPLIT) {
      // unnormalised state of (b, h, split, row i)
      const size_t prow = (((size_t)b * H + h) * ns + split) * C + i;
      if (lane == 0) {
        pm[prow] = m[r];
        pl[prow] = l[r];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        if (col < d) pacc[prow * d + col] = acc[r][c];
      }
    } else {
      const float denom = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = lane + 32 * c;
        if (col < d) o[qoff + (size_t)i * d + col] = from_float<T>(acc[r][c] / denom);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host-side launchers
// ---------------------------------------------------------------------------

struct DecodeArgs {
  const void* q;
  const void* kp;
  const void* vp;
  const float* ksc;      // int8 pools only
  const float* vsc;
  const int* table;
  const int* kv_len;
  void* o;               // normalised output (ns == 0)
  float* pm;             // partials (ns >= 1)
  float* pl;
  float* pacc;
  int B, H, Hkv, psz, nblk, ns, D;
  float scale;
  cudaStream_t st;
  int dp = 0;            // the padded instance's width (0: D's own)
};

template <typename T, typename S, int D, int GR, bool SPLIT, bool PAD>
cudaError_t launch_decode(const DecodeArgs& a) {
  auto kern = paged_decode_kernel<T, S, D, GR, SPLIT, PAD>;
  const int smem = a.nblk * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.Hkv, (a.H / a.Hkv) / GR, SPLIT ? a.ns : 1);
  kern<<<grid, k3::THREADS, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const S*>(a.kp),
      static_cast<const S*>(a.vp), a.ksc, a.vsc, a.table, a.kv_len,
      static_cast<T*>(a.o), a.pm, a.pl, a.pacc, a.H, a.Hkv, a.psz, a.nblk,
      a.scale, a.D);
  return cudaGetLastError();
}

template <typename T, typename S, int D, bool SPLIT, bool PAD>
cudaError_t decode_by_group(const DecodeArgs& a) {
  // rows per block: the largest of 8, 4, 2, 1 dividing the group size G; a
  // padded instance's largest is 4, and a wide one's (D > 256) 2, so that
  // its static shared memory (qs and the warps' accs, 36 KB at D = 256
  // and 4 rows, 36.9 KB at D = 512 and 2) stays under 48 KB
  const int G = a.H / a.Hkv;
  if constexpr (!PAD) {
    if (G % 8 == 0) return launch_decode<T, S, D, 8, SPLIT, PAD>(a);
  }
  if constexpr (D <= 256) {
    if (G % 4 == 0) return launch_decode<T, S, D, 4, SPLIT, PAD>(a);
  }
  if (G % 2 == 0) return launch_decode<T, S, D, 2, SPLIT, PAD>(a);
  return launch_decode<T, S, D, 1, SPLIT, PAD>(a);
}

// f(Int<D>, pad) for the instance of head dim d: with dp = 0 the head
// dim's own (D = 16, 32, 64 and 128: a decode lane owns D / 32 contiguous
// columns of a V row), else the padded instance of width dp (common.cuh's
// with_pad_width; h2o-danube-1.8b's 80, zamba2-7b's 112 and pixtral-12b's
// 160 run on the rungs 96, 128 and 160)
template <typename F>
cudaError_t with_dim(int d, int dp, F&& f) {
  if (dp > 0)
    return with_pad_width(dp, d, [&](auto w) {
      return f(w, std::true_type{});
    });
  if constexpr (kPaddedBuild) {
    return cudaErrorInvalidValue;
  } else {
    switch (d) {
      case 16: return f(Int<16>{}, std::false_type{});
      case 32: return f(Int<32>{}, std::false_type{});
      case 64: return f(Int<64>{}, std::false_type{});
      case 128: return f(Int<128>{}, std::false_type{});
      default: return cudaErrorInvalidValue;
    }
  }
}

template <typename T, typename S, bool SPLIT>
cudaError_t decode_by_dim(const DecodeArgs& a) {
  return with_dim(a.D, a.dp, [&](auto w, auto pad) {
    return decode_by_group<T, S, decltype(w)::value, SPLIT,
                           decltype(pad)::value>(a);
  });
}

// dtype of q (and of fp pools): 0 = float32 only (bf16: paged_decode.cu)
template <bool QUANT, bool SPLIT>
cudaError_t decode(const DecodeArgs& a, int dtype) {
  if (dtype == 0)
    return decode_by_dim<float, std::conditional_t<QUANT, int8_t, float>, SPLIT>(a);
  return cudaErrorInvalidValue;
}

struct PrefillArgs {
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
  int dp = 0;            // the padded instance's width (0: D's own)
};

template <typename T, typename S, int D, bool SPLIT, bool PAD>
cudaError_t launch_prefill(const PrefillArgs& a) {
  constexpr size_t smem = k4::smem_bytes<D>();
  auto kern = paged_prefill_kernel<T, S, D, SPLIT, PAD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (a.C + k4::bq<D>() - 1) / k4::bq<D>();
  const dim3 grid(n_tiles * (SPLIT ? a.ns : 1), a.H, a.B);
  kern<<<grid, k4::threads<D>(), smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const S*>(a.kp),
      static_cast<const S*>(a.vp), a.ksc, a.vsc, a.table, a.start, a.kv_len,
      static_cast<T*>(a.o), a.pm, a.pl, a.pacc, a.H, a.Hkv, a.C, a.psz,
      a.nblk, SPLIT ? a.ns : 1, a.scale, a.D);
  return cudaGetLastError();
}

template <typename T, typename S, bool SPLIT>
cudaError_t prefill_by_dim(const PrefillArgs& a) {
  return with_dim(a.D, a.dp, [&](auto w, auto pad) {
    return launch_prefill<T, S, decltype(w)::value, SPLIT,
                          decltype(pad)::value>(a);
  });
}

// K4, K5b, K6c and K6d take a float32 query only (bf16: paged_prefill.cu)
template <bool QUANT, bool SPLIT>
cudaError_t prefill(const PrefillArgs& a, int dtype) {
  if (SPLIT && a.ns < 1) return cudaErrorInvalidValue;
  if (dtype == 0)
    return prefill_by_dim<float, std::conditional_t<QUANT, int8_t, float>,
                          SPLIT>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: the type of q and of the output (and of fp pools): 0 = float32,
// 1 = bfloat16.  dp: 0 for the head dim D's own instance, else the width
// of the padded instance to run (kernels/flash_attention.py's route()).
// Each entry point returns the launch's cudaError_t (0 = success).  The
// caller validates shapes, contiguity, alignment and that every table
// entry below ceil(kv_len / psz) names a page of the pools, and allocates
// the outputs and partials; the kernels never allocate or sync.

// K3 with a float32 query (dtype 0 only): float32 pools, normalised output
// o (B, H, 1, D).
extern "C" int repro_flash_paged_decode(const void* q, const void* k_pool,
                                        const void* v_pool,
                                        const void* page_table,
                                        const void* kv_len, void* o, int B,
                                        int H, int Hkv, int psz, int nblk,
                                        int D, int dp, int dtype, float scale,
                                        void* stream) {
  DecodeArgs a{q, k_pool, v_pool, nullptr, nullptr,
               static_cast<const int*>(page_table),
               static_cast<const int*>(kv_len), o, nullptr, nullptr,
               nullptr, B, H, Hkv, psz, nblk, 1, D, scale,
               static_cast<cudaStream_t>(stream)};
  a.dp = dp;
  return decode<false, false>(a, dtype);
}

// K6a with a float32 query (dtype 0 only): int8 pools with scales (P, Hkv,
// psz), normalised output.
extern "C" int repro_flash_paged_decode_quant(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* kv_len, void* o, int B, int H, int Hkv, int psz, int nblk,
    int D, int dp, int dtype, float scale, void* stream) {
  DecodeArgs a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(page_table),
               static_cast<const int*>(kv_len), o, nullptr, nullptr,
               nullptr, B, H, Hkv, psz, nblk, 1, D, scale,
               static_cast<cudaStream_t>(stream)};
  a.dp = dp;
  return decode<true, false>(a, dtype);
}

// K5a with a float32 query (dtype 0 only): float32 pools, ns splits,
// partials m, l (B, Hkv, ns, G), acc (.., D).
extern "C" int repro_paged_decode_split(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* kv_len, void* m, void* l, void* acc,
    int B, int H, int Hkv, int psz, int nblk, int ns, int D, int dp, int dtype,
    float scale, void* stream) {
  DecodeArgs a{q, k_pool, v_pool, nullptr, nullptr,
               static_cast<const int*>(page_table),
               static_cast<const int*>(kv_len), nullptr,
               static_cast<float*>(m), static_cast<float*>(l),
               static_cast<float*>(acc), B, H, Hkv, psz, nblk, ns, D,
               scale, static_cast<cudaStream_t>(stream)};
  a.dp = dp;
  return decode<false, true>(a, dtype);
}

// K6b with a float32 query (dtype 0 only): int8 pools with scales, ns
// splits, partials as K5a.
extern "C" int repro_paged_decode_split_quant(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* kv_len, void* m, void* l, void* acc, int B, int H, int Hkv,
    int psz, int nblk, int ns, int D, int dp, int dtype, float scale, void* stream) {
  DecodeArgs a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(page_table),
               static_cast<const int*>(kv_len), nullptr,
               static_cast<float*>(m), static_cast<float*>(l),
               static_cast<float*>(acc), B, H, Hkv, psz, nblk, ns, D,
               scale, static_cast<cudaStream_t>(stream)};
  a.dp = dp;
  return decode<true, true>(a, dtype);
}

// K5c: partials m, l (BR, ns, rows), acc (BR, ns, rows, D) fp32 -> o
// (BR, rows, D) of type dtype.
extern "C" int repro_split_combine(const void* m, const void* l,
                                   const void* acc, void* o, int BR, int ns,
                                   int rows, int D, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D < 1 || D > 1024) return cudaErrorInvalidValue;
  const dim3 grid(BR, rows);
  const float* pm = static_cast<const float*>(m);
  const float* pl = static_cast<const float*>(l);
  const float* pa = static_cast<const float*>(acc);
  if (dtype == 0)
    split_combine_kernel<float><<<grid, D, 0, st>>>(
        pm, pl, pa, static_cast<float*>(o), ns, rows, D);
  else if (dtype == 1)
    split_combine_kernel<__nv_bfloat16><<<grid, D, 0, st>>>(
        pm, pl, pa, static_cast<__nv_bfloat16*>(o), ns, rows, D);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// K4 with a float32 query (dtype 0 only): float32 pools.
extern "C" int repro_paged_prefill_f32(const void* q, const void* k_pool,
                                       const void* v_pool,
                                       const void* page_table,
                                       const void* start, const void* kv_len,
                                       void* o, int B, int H, int Hkv, int C,
                                       int psz, int nblk, int D, int dp, int dtype,
                                       float scale, void* stream) {
  PrefillArgs a{q, k_pool, v_pool, nullptr, nullptr,
                static_cast<const int*>(page_table),
                static_cast<const int*>(start),
                static_cast<const int*>(kv_len), o, nullptr, nullptr,
                nullptr, B, H, Hkv, C, psz, nblk, 1, D, scale,
                static_cast<cudaStream_t>(stream)};
  a.dp = dp;
  return prefill<false, false>(a, dtype);
}

// K6c with a float32 query (dtype 0 only): int8 pools with scales
// (P, Hkv, psz).
extern "C" int repro_paged_prefill_f32_quant(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* start, const void* kv_len, void* o, int B, int H, int Hkv,
    int C, int psz, int nblk, int D, int dp, int dtype, float scale, void* stream) {
  PrefillArgs a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
                static_cast<const float*>(v_scale),
                static_cast<const int*>(page_table),
                static_cast<const int*>(start),
                static_cast<const int*>(kv_len), o, nullptr, nullptr,
                nullptr, B, H, Hkv, C, psz, nblk, 1, D, scale,
                static_cast<cudaStream_t>(stream)};
  a.dp = dp;
  return prefill<true, false>(a, dtype);
}

// K5b with a float32 query (dtype 0 only): float32 pools, ns splits,
// partials m, l (B, H, ns, C), acc (.., D).
extern "C" int repro_paged_prefill_split(
    const void* q, const void* k_pool, const void* v_pool,
    const void* page_table, const void* start, const void* kv_len, void* m,
    void* l, void* acc, int B, int H, int Hkv, int C, int psz, int nblk,
    int ns, int D, int dp, int dtype, float scale, void* stream) {
  PrefillArgs a{q, k_pool, v_pool, nullptr, nullptr,
                static_cast<const int*>(page_table),
                static_cast<const int*>(start),
                static_cast<const int*>(kv_len), nullptr,
                static_cast<float*>(m), static_cast<float*>(l),
                static_cast<float*>(acc), B, H, Hkv, C, psz, nblk, ns,
                D, scale, static_cast<cudaStream_t>(stream)};
  a.dp = dp;
  return prefill<false, true>(a, dtype);
}

// K6d with a float32 query (dtype 0 only): int8 pools with scales, ns
// splits, partials as K5b.
extern "C" int repro_paged_prefill_split_quant(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* start, const void* kv_len, void* m, void* l, void* acc,
    int B, int H, int Hkv, int C, int psz, int nblk, int ns, int D, int dp,
    int dtype, float scale, void* stream) {
  PrefillArgs a{q, k_pool, v_pool, static_cast<const float*>(k_scale),
                static_cast<const float*>(v_scale),
                static_cast<const int*>(page_table),
                static_cast<const int*>(start),
                static_cast<const int*>(kv_len), nullptr,
                static_cast<float*>(m), static_cast<float*>(l),
                static_cast<float*>(acc), B, H, Hkv, C, psz, nblk, ns,
                D, scale, static_cast<cudaStream_t>(stream)};
  a.dp = dp;
  return prefill<true, true>(a, dtype);
}
