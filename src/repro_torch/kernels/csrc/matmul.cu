// K8 matmul for Hopper (sm_90a): o = epilogue(x @ y + bias), fp32 sums.
// Plain C interface, bound from Python with ctypes (kernels/matmul.py); no
// PyTorch headers.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py: matmul / _mm_kernel,
// _mm_bias_kernel.  Same function: x (M, K) @ y (K, N) summed in fp32, an
// optional fp32 bias (N,) added before the epilogue (none, gelu in its tanh
// form, silu, relu), the result stored as float32 or bfloat16.
//
// Design.  The TPU kernel walks k as the innermost, sequential grid axis
// and carries the (bm, bn) fp32 sum in a VMEM scratch tile.  Blocks on
// Hopper run in no order, so here one block of 8 warps owns one
// (BM, BN) output tile and loops over K in BK steps itself: each step
// stages the (BM, BK) tile of x and the (BK, BN) tile of y in shared
// memory (rows padded by 16 bytes against bank conflicts), and the warps
// accumulate into registers.  Bias and epilogue are applied once to the
// fp32 tile before the store.  The kernel masks the ragged M/N/K edges
// itself (zeros staged past K; rows and columns past M/N not stored), so
// nothing is padded in device memory.
//  * bf16: tensor cores through mma.sync m16n8k16 with fp32 accumulation;
//    the 8 warps are laid out 2 x 4 over the tile, each owning a
//    (BM/2, BN/4) sub-tile of 16 x 8 fragments.
//  * fp32: plain fp32 FMAs (no TF32), so the result is a float32 product
//    as torch's "highest" float32 matmul precision gives; each thread owns
//    a (BM/16) x (BN/16) strided patch of the tile.
// Tile shapes are template parameters, one instance per (BM, BN, BK) in
// {32, 64, 128}^3 per dtype (the candidates of the MatmulBlocks install
// region); epilogue, bias and the output type are runtime arguments.
//
// What bounds it on an H100.  At yi-6b's MLP projection of a 512-token
// prefill (M=512, K=4096, N=11008, bf16) the product is 46.2 GFLOP against
// 105.6 MB of operands: compute-bound (0.047 ms at 989 TFLOP/s dense bf16).
// This first version is a simple synchronous tile loop: no cp.async or
// TMA pipeline, no wgmma, one stage of shared memory, so loads and
// tensor-core work do not overlap and it runs several times off that
// bound.  wgmma with a TMA ring is the later work that closes the gap.

#include "common.cuh"

namespace {

namespace k8 {
constexpr int THREADS = 256;     // 8 warps
constexpr int WARPS_M = 2;       // bf16: warps along the tile's rows
constexpr int WARPS_N = 4;       //       and along its columns

// Shared-memory bytes of one block: the x tile and the y tile, each row
// padded by 16 bytes.  kernels/matmul.py's smem_bytes is the same formula
// (the install-time cost model), and chip_smoke.py holds the two equal.
template <typename T>
constexpr size_t smem_bytes(int bm, int bn, int bk) {
  constexpr int pad = 16 / sizeof(T);
  return sizeof(T) * ((size_t)bm * (bk + pad) + (size_t)bk * (bn + pad));
}
}  // namespace k8

__device__ __forceinline__ float apply_epilogue(float x, int kind) {
  switch (kind) {
    case 1: {  // gelu, tanh form (jax.nn.gelu's default)
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case 2: return x / (1.0f + expf(-x));   // silu
    case 3: return fmaxf(x, 0.0f);          // relu
    default: return x;
  }
}

__device__ __forceinline__ void store_out(void* o, size_t idx, float v,
                                          int out_bf16) {
  if (out_bf16)
    static_cast<__nv_bfloat16*>(o)[idx] = __float2bfloat16(v);
  else
    static_cast<float*>(o)[idx] = v;
}

// Stage the (ROWS, COLS) tile at (r0, c0) of a row-major (nrows, ncols)
// matrix into shared memory with row stride SLD; elements past the edges
// are 0.  With vec, ncols is a multiple of the 16-byte vector and g is
// 16-byte aligned, so a vector is either wholly inside or wholly outside.
template <typename T, int ROWS, int COLS, int SLD>
__device__ __forceinline__ void load_tile(const T* __restrict__ g, int nrows,
                                          int ncols, int r0, int c0,
                                          T* __restrict__ s, int vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec) {
    constexpr int VPR = COLS / V;  // vectors per row
    for (int i = threadIdx.x; i < ROWS * VPR; i += k8::THREADS) {
      const int r = i / VPR, c = (i % VPR) * V;
      const int gr = r0 + r, gc = c0 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gr < nrows && gc < ncols)
        val = *reinterpret_cast<const uint4*>(g + (size_t)gr * ncols + gc);
      *reinterpret_cast<uint4*>(s + r * SLD + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += k8::THREADS) {
      const int r = i / COLS, c = i % COLS;
      const int gr = r0 + r, gc = c0 + c;
      s[r * SLD + c] = (gr < nrows && gc < ncols)
                           ? g[(size_t)gr * ncols + gc]
                           : from_float<T>(0.0f);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a @ b for one m16n8k16 fragment (bf16 in, fp32 accumulate).
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// bf16 inputs: tensor cores
// ---------------------------------------------------------------------------

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(k8::THREADS)
mm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ y,
               const float* __restrict__ bias, void* __restrict__ o, int M,
               int N, int K, int epilogue, int out_bf16, int vec_x,
               int vec_y) {
  using namespace k8;
  constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // warp sub-tile
  constexpr int MT = WM / 16, NT = WN / 8;             // fragments per warp
  constexpr int SA = BK + 8, SB = BN + 8;              // padded row strides
  static_assert(MT >= 1 && NT >= 1 && BK % 16 == 0, "tile too small");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + BM * SA;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, column pair
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<__nv_bfloat16, BM, BK, SA>(x, M, K, m0, k0, As, vec_x);
    load_tile<__nv_bfloat16, BK, BN, SB>(y, K, N, k0, n0, Bs, vec_y);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        // rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9
        const __nv_bfloat16* p = As + (wm * WM + mi * 16 + g) * SA + kk + 2 * t;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * SA);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * SA + 8);
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        // column g, rows (k) 2t, 2t + 1 and 2t + 8, 2t + 9
        const __nv_bfloat16* p = Bs + (kk + 2 * t) * SB + wn * WN + ni * 8 + g;
        b[ni][0] = pack_bf16(p[0], p[SB]);
        b[ni][1] = pack_bf16(p[8 * SB], p[9 * SB]);
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * WM + mi * 16 + g + 8 * half;
        const int col = n0 + wn * WN + ni * 8 + 2 * t;
        if (row >= M) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          if (col + c >= N) continue;
          float v = acc[mi][ni][2 * half + c];
          if (bias != nullptr) v += bias[col + c];
          store_out(o, (size_t)row * N + col + c, apply_epilogue(v, epilogue),
                    out_bf16);
        }
      }
}

// ---------------------------------------------------------------------------
// fp32 inputs: fp32 FMAs
// ---------------------------------------------------------------------------

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(k8::THREADS)
mm_f32_kernel(const float* __restrict__ x, const float* __restrict__ y,
              const float* __restrict__ bias, void* __restrict__ o, int M,
              int N, int K, int epilogue, int out_bf16, int vec_x,
              int vec_y) {
  using namespace k8;
  constexpr int TM = BM / 16, TN = BN / 16;  // outputs per thread
  constexpr int SA = BK + 4, SB = BN + 4;    // padded row strides
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* As = reinterpret_cast<float*>(smem_raw);
  float* Bs = As + BM * SA;

  // thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j of the tile:
  // a warp reads one or two rows of As (broadcast) and 16 consecutive
  // columns of Bs
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    load_tile<float, BM, BK, SA>(x, M, K, m0, k0, As, vec_x);
    load_tile<float, BK, BN, SB>(y, K, N, k0, n0, Bs, vec_y);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[(ty + 16 * i) * SA + kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk * SB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= N) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[col];
      store_out(o, (size_t)row * N + col, apply_epilogue(v, epilogue),
                out_bf16);
    }
  }
}

// ---------------------------------------------------------------------------
// launch and dispatch over the instantiated tiles
// ---------------------------------------------------------------------------

struct MmArgs {
  const void* x;
  const void* y;
  const float* bias;
  void* o;
  int M, N, K, epilogue, out_bf16, vec_x, vec_y;
};

// The kernel of an input type: fp32 FMAs for float, tensor cores for bf16.
template <typename T, int BM, int BN, int BK>
struct MmKernel;
template <int BM, int BN, int BK>
struct MmKernel<float, BM, BN, BK> {
  static constexpr auto fn = &mm_f32_kernel<BM, BN, BK>;
};
template <int BM, int BN, int BK>
struct MmKernel<__nv_bfloat16, BM, BN, BK> {
  static constexpr auto fn = &mm_bf16_kernel<BM, BN, BK>;
};

template <typename T, int BM, int BN, int BK>
cudaError_t launch_mm(const MmArgs& a, cudaStream_t stream) {
  constexpr size_t smem = k8::smem_bytes<T>(BM, BN, BK);
  const auto kernel = MmKernel<T, BM, BN, BK>::fn;
  // above 48 KB a block's dynamic shared memory must be opted into, once
  // per instance (per process: a later device shares the attribute)
  static cudaError_t opted = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (opted != cudaSuccess) return opted;
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
  kernel<<<grid, k8::THREADS, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.y), a.bias, a.o,
      a.M, a.N, a.K, a.epilogue, a.out_bf16, a.vec_x, a.vec_y);
  return cudaGetLastError();
}

template <typename T, int BM, int BN>
cudaError_t mm_by_bk(int bk, const MmArgs& a, cudaStream_t st) {
  switch (bk) {
    case 32: return launch_mm<T, BM, BN, 32>(a, st);
    case 64: return launch_mm<T, BM, BN, 64>(a, st);
    case 128: return launch_mm<T, BM, BN, 128>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int BM>
cudaError_t mm_by_bn(int bn, int bk, const MmArgs& a, cudaStream_t st) {
  switch (bn) {
    case 32: return mm_by_bk<T, BM, 32>(bk, a, st);
    case 64: return mm_by_bk<T, BM, 64>(bk, a, st);
    case 128: return mm_by_bk<T, BM, 128>(bk, a, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t mm_by_bm(int bm, int bn, int bk, const MmArgs& a,
                     cudaStream_t st) {
  switch (bm) {
    case 32: return mm_by_bn<T, 32>(bn, bk, a, st);
    case 64: return mm_by_bn<T, 64>(bn, bk, a, st);
    case 128: return mm_by_bn<T, 128>(bn, bk, a, st);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y alike); out_bf16: 1 stores
// bfloat16, 0 float32; epilogue: 0 none, 1 gelu (tanh), 2 silu, 3 relu;
// bias: a float32 (N,) vector or null.  (bm, bn, bk) must be an
// instantiated tile, each of 32, 64, 128.  Returns the launch's
// cudaError_t (0 = success).  The caller validates shapes and devices.
extern "C" int repro_matmul(const void* x, const void* y, const void* bias,
                            void* o, int M, int N, int K, int dtype,
                            int out_bf16, int epilogue, int bm, int bn,
                            int bk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int v = dtype == 0 ? 4 : 8;  // elements per 16-byte vector
  const MmArgs a{x, y, static_cast<const float*>(bias), o, M, N, K, epilogue,
                 out_bf16, (int)(K % v == 0 && aligned16(x)),
                 (int)(N % v == 0 && aligned16(y))};
  if (dtype == 0) return mm_by_bm<float>(bm, bn, bk, a, st);
  if (dtype == 1) return mm_by_bm<__nv_bfloat16>(bm, bn, bk, a, st);
  return cudaErrorInvalidValue;
}

// Shared-memory bytes one block of tile (bm, bn, bk) takes.
extern "C" long long repro_matmul_smem_bytes(int dtype, int bm, int bn,
                                             int bk) {
  return dtype == 0 ? (long long)k8::smem_bytes<float>(bm, bn, bk)
                    : (long long)k8::smem_bytes<__nv_bfloat16>(bm, bn, bk);
}

// The most shared memory a block may opt into on the current device
// (cudaDevAttrMaxSharedMemoryPerBlockOptin), or -1 if the query fails.
extern "C" int repro_smem_per_block_optin(void) {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  return bytes;
}
