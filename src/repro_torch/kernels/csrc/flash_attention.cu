// Flash attention for Hopper (sm_90a): self-attention for prefill (K1) and
// one-token decode against a dense KV cache (K2).  Plain C interface, bound
// from Python with ctypes (kernels/flash_attention.py); no PyTorch headers.
//
// K1  flash_attention_kernel  replaces the TPU kernel
//     src/repro/kernels/flash_attention.py: flash_attention / _attn_kernel.
// K2  flash_decode_kernel     replaces the TPU kernel
//     src/repro/kernels/flash_attention.py: flash_decode / _decode_kernel.
//
// Semantics kept from the TPU kernels: inputs are upcast to fp32 before
// every product, the online softmax runs in fp32, masked scores are
// -1e30 (not -inf), fully masked key tiles are skipped, and a row whose
// denominator is 0 (no key visible, e.g. kv_len == 0 in K2) yields exactly
// 0.  GQA maps query head h to kv head h / (H / Hkv).
//
// What bounds them on an H100.  K1 at a prefill of 512 tokens and K2 at
// every decode step are both memory-bound at their minimum: K2 must read
// B*Hkv*kv_len*D*2 (K and V) elements once per step, and K1 reads Q, K, V
// once.  These first versions are plain SIMT fp32 code, right before fast:
//  * K1: one block of 4 warps per (batch, head, 64-row query tile); K/V
//    tiles of 32 keys staged in shared memory as fp32 (lane j of a warp
//    owns key j of the tile, so the row max and sum are warp shuffles);
//    each warp owns 16 query rows and keeps their output rows in registers.
//    The Q tile and one K/V tile need 72 KB at D=128, above the 48 KB
//    static limit, so the kernel takes dynamic shared memory.
//  * K2: one block of 8 warps per (batch, kv head) holding the G grouped
//    query rows (the same fold as the TPU kernel), so each K/V element is
//    read from device memory once for all G rows (a group of more than 8
//    rows is split into blocks of 8, 4 or 2 along blockIdx.y).  The warps
//    split the cache into interleaved 32-key tiles up to kv_len[b] only,
//    each with its own online softmax state, merged at the end by a
//    max-shift in shared memory.  At 4 lanes of yi-6b that is 16 blocks on 132 SMs:
//    the card is mostly idle, and split-KV (K5) is where that gets fixed.
//    Tensor cores (wgmma) and TMA are left for the PRs that make these
//    kernels fast.

#include "common.cuh"

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

template <int D>
constexpr size_t smem_bytes() {
  // Q tile, K tile (rows padded to D + 1 so lane j reading key j's column
  // c hits bank (j + c) % 32), V tile, the warps' softmax numerators
  return sizeof(float) * (BQ * D + BK * (D + 1) + BK * D + BQ * BK);
}
}  // namespace k1

template <typename T, int D>
__global__ void __launch_bounds__(k1::THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int Hkv, int S, int causal, int window, float scale) {
  using namespace k1;
  constexpr int NC = (D + 31) / 32;  // output columns per lane
  constexpr int KS = D + 1;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + BQ * D;
  float* vs = ks + BK * KS;
  float* ps = vs + BK * D;

  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t qoff = ((size_t)b * H + h) * S * D;
  const size_t koff = ((size_t)b * Hkv + hk) * S * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r0 = (tid >> 5) * RPW;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int qi = q_start + i / D;
    qs[i] = qi < S ? to_float(q[qoff + (size_t)q_start * D + i]) : 0.f;
  }

  // live key tiles: causal needs k_start <= the tile's last query; the
  // window needs the tile's last key inside the first query's window
  const int n_k = (S + BK - 1) / BK;
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
      const bool in = k_start + j < S;
      const size_t g = koff + (size_t)k_start * D + i;
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
      bool live = kj < S;
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
      if (col < D) o[qoff + (size_t)qi * D + col] = from_float<T>(acc[r][c] / denom);
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

template <typename T, int D, int GR>
__global__ void __launch_bounds__(k2::THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len,
                    T* __restrict__ o, int H, int Hkv, int S, float scale) {
  using namespace k2;
  constexpr int NC = (D + 31) / 32;       // contiguous columns per lane
  constexpr int VN = 16 / sizeof(T);      // elements per 16-byte load
  __shared__ __align__(16) float qs[GR * D];
  __shared__ float ms[NWARPS][GR];
  __shared__ float ls[NWARPS][GR];
  __shared__ __align__(16) float accs[NWARPS][GR][D];

  const int b = blockIdx.x / Hkv;
  const int hk = blockIdx.x - b * Hkv;
  const int h0 = hk * (H / Hkv) + blockIdx.y * GR;  // first query row's head
  const size_t qoff = ((size_t)b * H + h0) * D;
  const size_t koff = ((size_t)b * Hkv + hk) * S * D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  for (int i = tid; i < GR * D; i += THREADS) qs[i] = to_float(q[qoff + i]);
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
      const T* kr = k + koff + (size_t)j * D;
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
    const T* vb = v + koff + (size_t)t * BK * D + lane * NC;
    for (int jj = 0; jj < n; ++jj) {
      float vv[NC];
      if (lane * NC < D) {
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
// host-side launchers
// ---------------------------------------------------------------------------

template <typename T, int D>
cudaError_t launch_attention(const void* q, const void* k, const void* v,
                             void* o, int B, int H, int Hkv, int S,
                             int causal, int window, float scale,
                             cudaStream_t stream) {
  constexpr size_t smem = k1::smem_bytes<D>();
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + k1::BQ - 1) / k1::BQ, H, B);
  kern<<<grid, k1::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, S, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T, int D, int GR>
cudaError_t launch_decode_gr(const void* q, const void* k, const void* v,
                             const int* kv_len, void* o, int B, int H,
                             int Hkv, int S, float scale,
                             cudaStream_t stream) {
  const dim3 grid(B * Hkv, (H / Hkv) / GR);
  flash_decode_kernel<T, D, GR><<<grid, k2::THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kv_len, static_cast<T*>(o), H, Hkv, S,
      scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int* kv_len, void* o, int B, int H, int Hkv,
                          int S, float scale, cudaStream_t stream) {
  // rows per block: the largest of 8, 4, 2, 1 dividing the group size G
  const int G = H / Hkv;
  if (G % 8 == 0)
    return launch_decode_gr<T, D, 8>(q, k, v, kv_len, o, B, H, Hkv, S, scale, stream);
  if (G % 4 == 0)
    return launch_decode_gr<T, D, 4>(q, k, v, kv_len, o, B, H, Hkv, S, scale, stream);
  if (G % 2 == 0)
    return launch_decode_gr<T, D, 2>(q, k, v, kv_len, o, B, H, Hkv, S, scale, stream);
  return launch_decode_gr<T, D, 1>(q, k, v, kv_len, o, B, H, Hkv, S, scale, stream);
}

template <typename T>
cudaError_t attention_by_dim(const void* q, const void* k, const void* v,
                             void* o, int B, int H, int Hkv, int S, int D,
                             int causal, int window, float scale,
                             cudaStream_t st) {
  switch (D) {
    case 16: return launch_attention<T, 16>(q, k, v, o, B, H, Hkv, S, causal, window, scale, st);
    case 32: return launch_attention<T, 32>(q, k, v, o, B, H, Hkv, S, causal, window, scale, st);
    case 64: return launch_attention<T, 64>(q, k, v, o, B, H, Hkv, S, causal, window, scale, st);
    case 128: return launch_attention<T, 128>(q, k, v, o, B, H, Hkv, S, causal, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t decode_by_dim(const void* q, const void* k, const void* v,
                          const int* kv_len, void* o, int B, int H, int Hkv,
                          int S, int D, float scale, cudaStream_t st) {
  switch (D) {
    case 16: return launch_decode<T, 16>(q, k, v, kv_len, o, B, H, Hkv, S, scale, st);
    case 32: return launch_decode<T, 32>(q, k, v, kv_len, o, B, H, Hkv, S, scale, st);
    case 64: return launch_decode<T, 64>(q, k, v, kv_len, o, B, H, Hkv, S, scale, st);
    case 128: return launch_decode<T, 128>(q, k, v, kv_len, o, B, H, Hkv, S, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no sliding window.
// Returns the launch's cudaError_t (0 = success).  The caller validates
// shapes, contiguity and alignment; the kernels never allocate or sync.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int B, int H,
                                     int Hkv, int S, int D, int dtype,
                                     int causal, int window, float scale,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return attention_by_dim<float>(q, k, v, o, B, H, Hkv, S, D, causal, window, scale, st);
  if (dtype == 1)
    return attention_by_dim<__nv_bfloat16>(q, k, v, o, B, H, Hkv, S, D, causal, window, scale, st);
  return cudaErrorInvalidValue;
}

extern "C" int repro_flash_decode(const void* q, const void* k, const void* v,
                                  const void* kv_len, void* o, int B, int H,
                                  int Hkv, int S, int D, int dtype,
                                  float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_len);
  if (dtype == 0)
    return decode_by_dim<float>(q, k, v, lens, o, B, H, Hkv, S, D, scale, st);
  if (dtype == 1)
    return decode_by_dim<__nv_bfloat16>(q, k, v, lens, o, B, H, Hkv, S, D, scale, st);
  return cudaErrorInvalidValue;
}
