// Paged attention for Hopper (sm_90a): one-token decode (K3) and chunked
// prefill (K4) against K/V page pools (P, Hkv, psz, D) shared by every
// sequence, each sequence reaching its pages through a row of a page table
// (B, nblk) int32.  Plain C interface, bound from Python with ctypes
// (kernels/paged_attention.py); no PyTorch headers.
//
// K3  flash_paged_decode_kernel   replaces the TPU kernel
//     src/repro/kernels/flash_attention.py: flash_paged_decode /
//     _paged_decode_kernel (num_splits=1).
// K4  flash_paged_prefill_kernel  replaces the TPU kernel
//     src/repro/kernels/flash_attention.py: flash_paged_prefill /
//     _paged_prefill_kernel (num_splits=1).
//
// Semantics kept from the TPU kernels: key j of sequence b lives in page
// table[b, j / psz] at slot j % psz; only keys j < kv_len[b] are read (table
// entries past ceil(kv_len / psz) are never read, so they may point
// anywhere, page 0 by convention); inputs are upcast to fp32 before every
// product, the online softmax runs in fp32 with -1e30 masking, and a row
// that sees no key (kv_len == 0) yields exactly 0.  GQA maps query head h
// to kv head h / (H / Hkv).  Any page size works: addresses are computed
// per key row, so a 32-key tile may span several pages.
//
// What bounds them on an H100.  Both are memory-bound at the serving
// shapes: K3 must read every live K/V row once per step (4.2 MB at four
// yi-6b lanes of ~520 tokens), K4 reads the chunk's Q and the committed
// K/V prefix once.  These first versions keep the structure of K2 and K1:
//  * K3: one block of 8 warps per (lane, kv head) holding the G grouped
//    query rows, so each K/V row is read from device memory once for all G
//    rows.  The block stages the lane's live page-table entries in shared
//    memory once; each lane of a warp owns one key of a 32-key tile, finds
//    its row through the staged table, and the warps split the tiles and
//    merge their (m, l, acc) states by a max-shift in shared memory.  The
//    row offset a lane found is broadcast by a shuffle to the value pass.
//  * K4: one block of 4 warps per (sequence, head, 64-row query tile);
//    query row i sits at absolute position start[b] + i.  K/V tiles of 32
//    keys are staged in shared memory as fp32 (rows padded to D + 1), each
//    row fetched through the table; a tile is skipped when it starts at or
//    past kv_len or past the tile's last query.  Rows past the chunk are
//    padding: loaded as 0, never stored.
//    Tensor cores (wgmma), TMA and split-KV (K5) are left for later PRs.

#include "common.cuh"

namespace {

// offset (in elements) of key j's row for kv head hk, through the staged
// table: pool[tbl[j / psz], hk, j % psz, :]
__device__ __forceinline__ size_t row_offset(const int* tbl, int j, int hk,
                                             int Hkv, int psz, int D) {
  const int blk = j / psz;
  return (((size_t)tbl[blk] * Hkv + hk) * psz + (j - blk * psz)) * D;
}

// ---------------------------------------------------------------------------
// K3: paged decode, q (B, H, 1, D), pools (P, Hkv, psz, D), table (B, nblk),
// kv_len (B,) int32.  Dynamic shared memory: the lane's live table entries.
// ---------------------------------------------------------------------------

namespace k3 {
constexpr int BK = 32;             // keys per warp tile: lane j owns key j
constexpr int NWARPS = 8;
constexpr int THREADS = NWARPS * 32;
}  // namespace k3

template <typename T, int D, int GR>
__global__ void __launch_bounds__(k3::THREADS)
flash_paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                          const T* __restrict__ vp,
                          const int* __restrict__ table,
                          const int* __restrict__ kv_len, T* __restrict__ o,
                          int H, int Hkv, int psz, int nblk, float scale) {
  using namespace k3;
  constexpr int NC = (D + 31) / 32;       // contiguous columns per lane
  constexpr int VN = 16 / sizeof(T);      // elements per 16-byte load
  extern __shared__ int tbl[];            // the lane's live table entries
  __shared__ __align__(16) float qs[GR * D];
  __shared__ float ms[NWARPS][GR];
  __shared__ float ls[NWARPS][GR];
  __shared__ __align__(16) float accs[NWARPS][GR][D];

  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x - b * Hkv;
  const int h0 = hk * (H / Hkv) + blockIdx.y * GR;  // first query row's head
  const size_t qoff = ((size_t)b * H + h0) * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int len = min(max(kv_len[b], 0), nblk * psz);
  const int n_live = (len + psz - 1) / psz;
  for (int i = tid; i < n_live; i += THREADS) tbl[i] = table[(size_t)b * nblk + i];
  for (int i = tid; i < GR * D; i += THREADS) qs[i] = to_float(q[qoff + i]);
  __syncthreads();

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
    const unsigned long long roff =
        live ? row_offset(tbl, j, hk, Hkv, psz, D) : 0ull;
    float s[GR];
#pragma unroll
    for (int g = 0; g < GR; ++g) s[g] = 0.f;
    if (live) {
      const T* kr = kp + roff;
#pragma unroll 4
      for (int c = 0; c < D; c += VN) {
        float kf[VN];
        load_f32<VN>(kr + c, kf);
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
      const unsigned long long vo = __shfl_sync(kFull, roff, jj);
      float vv[NC];
      if (lane * NC < D) {
        load_f32<NC>(vp + vo + lane * NC, vv);
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
    const int d = i - g * D;
    float m_star = kNegInf;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) m_star = fmaxf(m_star, ms[w][g]);
    float l_star = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float e = expf(ms[w][g] - m_star);
      l_star += ls[w][g] * e;
      a += accs[w][g][d] * e;
    }
    o[qoff + i] = from_float<T>(a / (l_star == 0.f ? 1.f : l_star));
  }
}

// ---------------------------------------------------------------------------
// K4: paged chunked prefill, q (B, H, C, D), pools (P, Hkv, psz, D), table
// (B, nblk), start and kv_len (B,) int32, o like q.
// ---------------------------------------------------------------------------

namespace k4 {
constexpr int BQ = 64;             // query rows per block
constexpr int BK = 32;             // keys per tile: lane j owns key j
constexpr int NWARPS = 4;
constexpr int THREADS = NWARPS * 32;
constexpr int RPW = BQ / NWARPS;   // query rows per warp

template <int D>
constexpr size_t smem_bytes() {
  // Q tile, K tile (rows padded to D + 1 so lane j reading key j's column
  // c hits bank (j + c) % 32), V tile, the warps' softmax numerators
  return sizeof(float) * (BQ * D + BK * (D + 1) + BK * D + BQ * BK);
}
}  // namespace k4

template <typename T, int D>
__global__ void __launch_bounds__(k4::THREADS)
flash_paged_prefill_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                           const T* __restrict__ vp,
                           const int* __restrict__ table,
                           const int* __restrict__ start,
                           const int* __restrict__ kv_len, T* __restrict__ o,
                           int H, int Hkv, int C, int psz, int nblk,
                           float scale) {
  using namespace k4;
  constexpr int NC = (D + 31) / 32;  // output columns per lane
  constexpr int KS = D + 1;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + BQ * D;
  float* vs = ks + BK * KS;
  float* ps = vs + BK * D;
  __shared__ size_t roffs[BK];       // the tile's key rows in the pools

  const int i0 = blockIdx.x * BQ;    // first chunk row of the tile
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t qoff = ((size_t)b * H + h) * C * D;
  const int* tbl = table + (size_t)b * nblk;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * RPW;
  const int len = min(max(kv_len[b], 0), nblk * psz);
  const int q_start = start[b] + i0;   // absolute position of row i0

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int qi = i0 + i / D;
    qs[i] = qi < C ? to_float(q[qoff + (size_t)i0 * D + i]) : 0.f;
  }

  // live key tiles: committed (k_start < kv_len) and causally visible to
  // the tile's last query (k_start <= q_start + BQ - 1)
  const int last = q_start + BQ - 1;
  const int t_hi = last < 0 ? 0 : min((len + BK - 1) / BK, last / BK + 1);

  float m[RPW], l[RPW], acc[RPW][NC];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }

  for (int t = 0; t < t_hi; ++t) {
    const int k_start = t * BK;
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    if (tid < BK) {
      const int kj = k_start + tid;
      roffs[tid] = kj < len ? row_offset(tbl, kj, hk, Hkv, psz, D) : 0;
    }
    __syncthreads();
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D;
      const int c = i - j * D;
      const bool in = k_start + j < len;
      const size_t g = roffs[j] + c;
      ks[j * KS + c] = in ? to_float(kp[g]) : 0.f;
      vs[i] = in ? to_float(vp[g]) : 0.f;
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
    const int i = i0 + r0 + r;
    if (i >= C) continue;              // padding of the last q tile
    const float denom = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < D) o[qoff + (size_t)i * D + col] = from_float<T>(acc[r][c] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// host-side launchers
// ---------------------------------------------------------------------------

template <typename T, int D, int GR>
cudaError_t launch_paged_decode_gr(const void* q, const void* kp,
                                   const void* vp, const int* table,
                                   const int* kv_len, void* o, int B, int H,
                                   int Hkv, int psz, int nblk, float scale,
                                   cudaStream_t stream) {
  auto kern = flash_paged_decode_kernel<T, D, GR>;
  const int smem = nblk * (int)sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hkv, (H / Hkv) / GR);
  kern<<<grid, k3::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, kv_len, static_cast<T*>(o), H, Hkv,
      psz, nblk, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_paged_decode(const void* q, const void* kp, const void* vp,
                                const int* table, const int* kv_len, void* o,
                                int B, int H, int Hkv, int psz, int nblk,
                                float scale, cudaStream_t st) {
  // rows per block: the largest of 8, 4, 2, 1 dividing the group size G
  const int G = H / Hkv;
  if (G % 8 == 0)
    return launch_paged_decode_gr<T, D, 8>(q, kp, vp, table, kv_len, o, B, H, Hkv, psz, nblk, scale, st);
  if (G % 4 == 0)
    return launch_paged_decode_gr<T, D, 4>(q, kp, vp, table, kv_len, o, B, H, Hkv, psz, nblk, scale, st);
  if (G % 2 == 0)
    return launch_paged_decode_gr<T, D, 2>(q, kp, vp, table, kv_len, o, B, H, Hkv, psz, nblk, scale, st);
  return launch_paged_decode_gr<T, D, 1>(q, kp, vp, table, kv_len, o, B, H, Hkv, psz, nblk, scale, st);
}

template <typename T, int D>
cudaError_t launch_paged_prefill(const void* q, const void* kp,
                                 const void* vp, const int* table,
                                 const int* start, const int* kv_len, void* o,
                                 int B, int H, int Hkv, int C, int psz,
                                 int nblk, float scale, cudaStream_t stream) {
  constexpr size_t smem = k4::smem_bytes<D>();
  auto kern = flash_paged_prefill_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((C + k4::BQ - 1) / k4::BQ, H, B);
  kern<<<grid, k4::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, start, kv_len, static_cast<T*>(o), H,
      Hkv, C, psz, nblk, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t paged_decode_by_dim(const void* q, const void* kp, const void* vp,
                                const int* table, const int* kv_len, void* o,
                                int B, int H, int Hkv, int psz, int nblk,
                                int D, float scale, cudaStream_t st) {
  switch (D) {
    case 16: return launch_paged_decode<T, 16>(q, kp, vp, table, kv_len, o, B, H, Hkv, psz, nblk, scale, st);
    case 32: return launch_paged_decode<T, 32>(q, kp, vp, table, kv_len, o, B, H, Hkv, psz, nblk, scale, st);
    case 64: return launch_paged_decode<T, 64>(q, kp, vp, table, kv_len, o, B, H, Hkv, psz, nblk, scale, st);
    case 128: return launch_paged_decode<T, 128>(q, kp, vp, table, kv_len, o, B, H, Hkv, psz, nblk, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t paged_prefill_by_dim(const void* q, const void* kp,
                                 const void* vp, const int* table,
                                 const int* start, const int* kv_len, void* o,
                                 int B, int H, int Hkv, int C, int psz,
                                 int nblk, int D, float scale,
                                 cudaStream_t st) {
  switch (D) {
    case 16: return launch_paged_prefill<T, 16>(q, kp, vp, table, start, kv_len, o, B, H, Hkv, C, psz, nblk, scale, st);
    case 32: return launch_paged_prefill<T, 32>(q, kp, vp, table, start, kv_len, o, B, H, Hkv, C, psz, nblk, scale, st);
    case 64: return launch_paged_prefill<T, 64>(q, kp, vp, table, start, kv_len, o, B, H, Hkv, C, psz, nblk, scale, st);
    case 128: return launch_paged_prefill<T, 128>(q, kp, vp, table, start, kv_len, o, B, H, Hkv, C, psz, nblk, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t
// (0 = success).  The caller validates shapes, contiguity, alignment and
// that every table entry below ceil(kv_len / psz) names a page of the
// pools; the kernels never allocate or sync.
extern "C" int repro_flash_paged_decode(const void* q, const void* k_pool,
                                        const void* v_pool,
                                        const void* page_table,
                                        const void* kv_len, void* o, int B,
                                        int H, int Hkv, int psz, int nblk,
                                        int D, int dtype, float scale,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(page_table);
  const int* lens = static_cast<const int*>(kv_len);
  if (dtype == 0)
    return paged_decode_by_dim<float>(q, k_pool, v_pool, tbl, lens, o, B, H, Hkv, psz, nblk, D, scale, st);
  if (dtype == 1)
    return paged_decode_by_dim<__nv_bfloat16>(q, k_pool, v_pool, tbl, lens, o, B, H, Hkv, psz, nblk, D, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" int repro_flash_paged_prefill(const void* q, const void* k_pool,
                                         const void* v_pool,
                                         const void* page_table,
                                         const void* start,
                                         const void* kv_len, void* o, int B,
                                         int H, int Hkv, int C, int psz,
                                         int nblk, int D, int dtype,
                                         float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(page_table);
  const int* st0 = static_cast<const int*>(start);
  const int* lens = static_cast<const int*>(kv_len);
  if (dtype == 0)
    return paged_prefill_by_dim<float>(q, k_pool, v_pool, tbl, st0, lens, o, B, H, Hkv, C, psz, nblk, D, scale, st);
  if (dtype == 1)
    return paged_prefill_by_dim<__nv_bfloat16>(q, k_pool, v_pool, tbl, st0, lens, o, B, H, Hkv, C, psz, nblk, D, scale, st);
  return cudaErrorInvalidValue;
}
