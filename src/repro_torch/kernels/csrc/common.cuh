// Device helpers shared by the port's attention kernels (flash_attention.cu,
// paged_attention.cu): fp32 conversion of the storage types (float, bf16,
// and the int8 codes of quantized pages), warp reductions, vector loads,
// and K5c's split merge with the last-arrival protocol that puts it in the
// split phase-1 kernels' epilogue.  Each .cu file builds into its own library,
// so everything here has internal linkage.  kernels/build.py hashes this
// header together with every source, so a change here rebuilds both.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <int N>
using Int = std::integral_constant<int, N>;

// The padded instances (PAD = true in a kernel's template): the template's
// head dim D is the instance's width DP, one of the rungs below, and a
// run-time head dim d <= DP gives the row strides of q, k, v, o, the pools
// and the partials.  Columns at and past d load as zero (shared memory keeps
// DP columns) and are never stored, so zero columns add exact zeros to
// Q.K^T and P.V's extra columns are dropped: at a d with an instance of its
// own the padded one gives the same bits.  A head dim with no instance of
// its own runs on the smallest rung at or above it (kernels/
// flash_attention.py's PADDED_HEAD_DIMS and route()).  f(Int<DP>) for a
// rung, else cudaErrorInvalidValue.
//
// Each attention source builds into three libraries, side by side
// (kernels/build.py): one with the instances of their own (REPRO_PADDED
// 0), one with the padded ones up to 256 (REPRO_PADDED 1) and one with the
// wide rungs 384 and 512 (REPRO_WIDE 1, below); a library asked for an
// instance of another part returns cudaErrorInvalidValue.
//
// The wide instances (D > 256: every head dim from 257 to 512) are padded
// instances whose head dim is split across warps: a 16-row mma slab is
// served by NS = D / 128 warps, warp `slice` holding the Q fragments and
// the O accumulator of columns slice * 128 .. + 127 (64 fp32 a thread,
// where one warp holding all 512 columns would need 256).  Each warp
// computes its slice's partial Q.K^T; the NS partials meet in shared
// memory and every warp of the slab sums them in slice order (sum_slices,
// mma.cuh), so all hold the same S, run the same online softmax, and add
// P.V_slice into their own O columns.  Key tiles are 32 keys.  Why no rung
// above 512: kernels/flash_attention.py's LIMIT_REASON.
#ifndef REPRO_PADDED
#define REPRO_PADDED 0
#endif
#ifndef REPRO_WIDE
#define REPRO_WIDE 0
#endif
constexpr bool kWideBuild = REPRO_WIDE != 0;
constexpr bool kPaddedBuild = REPRO_PADDED != 0 || kWideBuild;

// column slices (warps) of a slab at head dim D: D / 128 above 256, else 1
template <int D>
__host__ __device__ constexpr int head_slices() {
  return D > 256 ? D / 128 : 1;
}

template <typename F>
cudaError_t with_pad_width(int dp, int d, F&& f) {
  if constexpr (!kPaddedBuild) {
    return cudaErrorInvalidValue;
  } else if constexpr (kWideBuild) {
    if (d < 1 || d > dp) return cudaErrorInvalidValue;
    switch (dp) {
      case 384: return f(Int<384>{});
      case 512: return f(Int<512>{});
      default: return cudaErrorInvalidValue;
    }
  } else {
    if (d < 1 || d > dp) return cudaErrorInvalidValue;
    switch (dp) {
      case 64: return f(Int<64>{});
      case 96: return f(Int<96>{});
      case 128: return f(Int<128>{});
      case 160: return f(Int<160>{});
      case 192: return f(Int<192>{});
      case 256: return f(Int<256>{});
      default: return cudaErrorInvalidValue;
    }
  }
}

// The first n < 4 (or all 4) floats of p, zeros after: a partial's row of a
// padded instance, whose width d need not keep float4 alignment.
__device__ __forceinline__ float4 ldcg_part4(const float* p, int n) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n > 0) v.x = __ldcg(p);
  if (n > 1) v.y = __ldcg(p + 1);
  if (n > 2) v.z = __ldcg(p + 2);
  if (n > 3) v.w = __ldcg(p + 3);
  return v;
}
__device__ __forceinline__ void st_part4(float* p, float4 v, int n) {
  if (n > 0) p[0] = v.x;
  if (n > 1) p[1] = v.y;
  if (n > 2) p[2] = v.z;
  if (n > 3) p[3] = v.w;
}
// the first n of the 4 bf16 roundings of v at p
__device__ __forceinline__ void st_bf16_part4(__nv_bfloat16* p, float4 v,
                                              int n) {
  if (n > 0) p[0] = __float2bfloat16(v.x);
  if (n > 1) p[1] = __float2bfloat16(v.y);
  if (n > 2) p[2] = __float2bfloat16(v.z);
  if (n > 3) p[3] = __float2bfloat16(v.w);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Butterfly reductions: every lane ends with the same value.
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// K5c's merge of the ns split states (m_s, l_s, acc_s) of one row, the
// steps every caller shares (paged_attention.cu's split_combine_kernel and
// the last-arrival merge of the split phase-1 kernels below):
//   m* = max_s m_s;  for s = 0 .. ns - 1 in that order: alpha = e^(m_s - m*),
//   l* += l_s * alpha, a += acc_s * alpha;  o = a / (l* == 0 ? 1 : l*).
// Each step is pinned (round-to-nearest subtract, fused multiply-add,
// division), so that both call sites compile to the same operations and
// give bit-equal outputs from the same partials.  The max does not depend
// on the order; the sums do, and stay in split order.  A row whose splits
// are all empty (-1e30, 0, 0) gives exactly 0.
__device__ __forceinline__ float split_alpha(float m_s, float m_star) {
  return expf(__fsub_rn(m_s, m_star));
}
__device__ __forceinline__ float split_fma(float sum, float x, float alpha) {
  return __fmaf_rn(x, alpha, sum);
}
__device__ __forceinline__ float split_out(float a, float l_star) {
  return __fdiv_rn(a, l_star == 0.f ? 1.f : l_star);
}

// The last-arrival merge: K5c inside a split phase-1 kernel.  Every thread
// of the CTA calls it once the CTA's partials are stored.  The ns CTAs of
// one output tile count their arrivals on *cnt (after a fence that makes
// their stores visible device-wide); the last to arrive merges the ns
// states of each of the tile's `rows` rows (split s of row r at index
// prow(r) + s * sstride of pm and pl, times D of pacc, read through L2)
// into the bf16 output row orow(r), as K5c does, then resets *cnt to 0.  No
// CTA waits on another, so nothing depends on which CTAs are co-resident
// or in what order they run.  What the merge costs is rounds of dependent
// L2 loads, so each round issues all it can: one warp a row (a warp's
// rows loaded together), 32 splits at a time, lane j holding split s0 + j
// (m* is taken over the first 32 and, past them, the rest), the lanes'
// weights and l* in split order through shuffles; then the CTA's threads own 4 columns of a row each and load
// the acc rows of U splits of all their rows at once before summing them
// in split order.  `scratch` holds 1 + 33 * MAXR words of shared memory
// that no thread reads or writes after it has called this function.  A
// padded instance (PAD) reads and writes rows of d <= D columns: where d <
// D the chunks at and past d are skipped and a chunk that d cuts is read
// and stored element by element; at d = D it runs the full-row code.
template <int D, int THREADS, int MAXR, bool PAD = false, typename RowFn,
          typename OutFn>
__device__ __forceinline__ void merge_splits_if_last(
    int* cnt, int ns, int rows, const float* pm, const float* pl,
    const float* pacc, size_t sstride, RowFn prow, OutFn orow,
    float* scratch, int d = D) {
  constexpr int C4 = D / 4;                            // 4-column chunks
  const int W = PAD ? d : D;                           // a row's columns
  const bool part = PAD && W != D;                     // narrower rows
  constexpr int PER = (MAXR * C4 + THREADS - 1) / THREADS;
  constexpr int NW = THREADS / 32;
  constexpr int RPW = (MAXR + NW - 1) / NW;            // rows per warp
  // splits per round: 16 / PER, so that a thread holds at most 16 float4
  // of acc rows in flight (8 chunks a thread, as a 64-thread CTA or a
  // 64-row tile has, take 2 a round)
  constexpr int U = PER >= 16 ? 1 : 16 / PER;
  int* last = reinterpret_cast<int*>(scratch);
  float* lst = scratch + 1;                            // l* per row
  float* wts = lst + MAXR;                             // [MAXR][32] weights
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // the CTA's stores, ordered before thread 0's count by the barrier, are
  // released by that count, an acquire-release add at GPU scope (CUTLASS's
  // barrier takes the same steps: a barrier, then one thread's release);
  // the last to count acquires every other CTA's stores with it, and its
  // barrier passes them on to the CTA's threads
  __syncthreads();
  if (tid == 0) {
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(prev)
                 : "l"(cnt)
                 : "memory");
    *last = prev == ns - 1;
  }
  __syncthreads();
  if (!*last) return;

  // the thread's output chunks: (row, 4 columns) e = tid + k * THREADS;
  // the warp's rows: warp + i * NW, their m* and l*
  float4 a[PER];
  float mx[RPW], ls[RPW];
#pragma unroll
  for (int k = 0; k < PER; ++k) a[k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < RPW; ++i) ls[i] = 0.f;
  for (int s0 = 0; s0 < ns; s0 += 32) {
    const int n = min(32, ns - s0);
    float mv[RPW], lv[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + i * NW;
      mv[i] = kNegInf;
      lv[i] = 0.f;
      if (r < rows && lane < n) {
        const size_t j = prow(r) + (size_t)(s0 + lane) * sstride;
        mv[i] = __ldcg(pm + j);
        lv[i] = __ldcg(pl + j);
      }
    }
    if (s0 == 0) {     // m* over these splits and, past 32, the others
#pragma unroll
      for (int i = 0; i < RPW; ++i) mx[i] = mv[i];
      for (int s = 32 + lane; s < ns; s += 32) {
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
          const int r = warp + i * NW;
          if (r < rows)
            mx[i] = fmaxf(mx[i], __ldcg(pm + prow(r) + (size_t)s * sstride));
        }
      }
#pragma unroll
      for (int i = 0; i < RPW; ++i) mx[i] = warp_max(mx[i]);
    }
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + i * NW;
      if (r < rows) {                                  // the whole warp
        const float alpha = lane < n ? split_alpha(mv[i], mx[i]) : 0.f;
        wts[r * 32 + lane] = alpha;
        for (int j = 0; j < n; ++j)
          ls[i] = split_fma(ls[i], __shfl_sync(kFull, lv[i], j),
                            __shfl_sync(kFull, alpha, j));
      }
    }
    __syncthreads();   // every row's weights of splits s0 ..
    const float* src[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int e = tid + k * THREADS;
      const int r = e / C4;
      const int col = (e - r * C4) * 4;
      src[k] = e < rows * C4 && (!part || col < W)
                   ? pacc + (prow(r) + (size_t)s0 * sstride) * W + col
                   : nullptr;
    }
    for (int j0 = 0; j0 < n; j0 += U) {
      float4 v[U][PER];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < PER; ++k)
          if (src[k] && j0 + u < n) {
            const float* p = src[k] + (size_t)(j0 + u) * sstride * W;
            if (part)
              v[u][k] = ldcg_part4(p, W - ((tid + k * THREADS) % C4) * 4);
            else
              v[u][k] = __ldcg(reinterpret_cast<const float4*>(p));
          }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int k = 0; k < PER; ++k)
          if (src[k] && j0 + u < n) {
            const float w = wts[(tid + k * THREADS) / C4 * 32 + j0 + u];
            a[k].x = split_fma(a[k].x, v[u][k].x, w);
            a[k].y = split_fma(a[k].y, v[u][k].y, w);
            a[k].z = split_fma(a[k].z, v[u][k].z, w);
            a[k].w = split_fma(a[k].w, v[u][k].w, w);
          }
    }
    __syncthreads();   // the weights are rewritten by the next splits
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + i * NW;
    if (r < rows && lane == 0) lst[r] = ls[i];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int e = tid + k * THREADS;
    if (e < rows * C4) {
      const int r = e / C4;
      const int col = (e - r * C4) * 4;
      if (part && col >= W) continue;
      const float l_star = lst[r];
      if (part) {
        st_bf16_part4(orow(r) + col,
                      make_float4(split_out(a[k].x, l_star),
                                  split_out(a[k].y, l_star),
                                  split_out(a[k].z, l_star),
                                  split_out(a[k].w, l_star)),
                      W - col);
        continue;
      }
      const __nv_bfloat162 lo = __floats2bfloat162_rn(
          split_out(a[k].x, l_star), split_out(a[k].y, l_star));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(
          split_out(a[k].z, l_star), split_out(a[k].w, l_star));
      uint2 out;
      out.x = *reinterpret_cast<const uint32_t*>(&lo);
      out.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(orow(r) + col) = out;
    }
  }
  if (tid == 0) *cnt = 0;   // every split has arrived: ready for the next launch
}

// N consecutive elements starting at p (aligned to N elements) -> fp32.
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void load_f32(const __nv_bfloat16* p, float* out) {
  if constexpr (N == 8) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x; out[2 * i + 1] = f.y;
    }
  } else if constexpr (N == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x; out[2 * i + 1] = f.y;
    }
  } else if constexpr (N == 2) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = f.x; out[1] = f.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = __bfloat162float(p[i]);
  }
}

// N consecutive int8 codes starting at p (aligned to N bytes) -> fp32.
template <int N>
__device__ __forceinline__ void load_f32(const int8_t* p, float* out) {
  if constexpr (N == 16 || N == 8 || N == 4 || N == 2) {
    using V = std::conditional_t<N == 16, uint4,
              std::conditional_t<N == 8, uint2,
              std::conditional_t<N == 4, uint32_t, uint16_t>>>;
    const V t = *reinterpret_cast<const V*>(p);
    const int8_t* c = reinterpret_cast<const int8_t*>(&t);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = static_cast<float>(c[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = static_cast<float>(p[i]);
  }
}

}  // namespace
