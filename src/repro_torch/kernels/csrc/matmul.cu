// K8 matmul for Hopper (sm_90a): o = epilogue(x @ y + bias), fp32 sums.
// Plain C interface, bound from Python with ctypes (kernels/matmul.py); no
// PyTorch headers.
//
// Replaces the TPU kernel src/repro/kernels/matmul.py: matmul (pallas_call
// :111) / _mm_kernel, _mm_bias_kernel.  Same function: x (M, K) @ y (K, N)
// summed in fp32, an optional fp32 bias (N,) added before the epilogue
// (none, gelu in its tanh form, silu, relu), the result stored as float32
// or bfloat16.
//
// Design.  The TPU kernel walks k as the innermost, sequential grid axis
// and carries the (bm, bn) fp32 sum in a VMEM scratch tile.  Blocks on
// Hopper run in no order, so here one block owns one (BM, BN) output tile
// and loops over K in BK steps itself; bias and epilogue are applied once
// to the fp32 tile before the store.  Tile shapes are template parameters,
// one instance per (BM, BN, BK) in {32, 64, 128}^3 per dtype (the
// candidates of the MatmulBlocks install region, 54 instances); epilogue,
// bias and the output type are runtime arguments.  Three kernels:
//  * bf16, BM 64 or 128 (mm_bf16_wgmma_kernel): a producer warp keeps a
//    ring of stages in flight, each stage the (BM, BK) tile of x and the
//    (BK, BN) tile of y brought by TMA (cp.async.bulk.tensor, one thread,
//    completion counted in bytes on the stage's "full" mbarrier); one
//    consumer warpgroup per 64 rows runs wgmma.mma_async m64nBNk16 (bf16
//    in, fp32 accumulators in registers) straight from shared memory and,
//    once the products that read a stage are done, frees it on its
//    "empty" mbarrier (one arrival per consumer warp).  x is K-major; y,
//    row-major (K, N), is the MN-major ("transposed") B operand.  Each
//    operand lands in swizzled atoms of 8 rows of 64 bf16 (128-byte
//    swizzle) or of 32 for a 32-wide extent (64-byte swizzle), a 128-wide
//    extent as two atoms: the layout TMA writes and wgmma's descriptors
//    read, free of bank conflicts.  The ring holds as many stages (2 to
//    8) as fit 96 KB per consumer warpgroup, so that an SM runs two
//    warpgroups (one block of BM 128, two of 64) and the copies in flight
//    cover the L2 latency: at the main path's shape the copies alone take
//    longer than the products alone (PERF.md), and a deeper ring at one
//    block an SM beat a shallow one at two.  Blocks
//    walk M fastest, so the few row tiles of one column of y run together
//    and y (the large operand at the main path's shape) is read from
//    device memory about once.  TMA's out-of-bounds zero fill covers
//    ragged M, N and K; rows and columns past M/N are not stored.
//  * bf16, BM 32, or a shape TMA cannot describe (mm_bf16_mma_kernel):
//    TMA needs 16-byte row strides and bases (K and N multiples of 8, x
//    and y 16-byte aligned), and wgmma 64 rows.  kernels/matmul.py's
//    route() sends such calls here, at (32, BN, BK): 8 warps in a 2 x 4
//    layout of mma.sync m16n8k16 fragments over one stage of shared
//    memory (rows padded by 16 bytes), the ragged edges masked in the
//    staging.  A synchronous tile loop: loads and products do not overlap.
//  * fp32 (mm_f32_kernel): plain fp32 FMAs (no TF32), so the result is a
//    float32 product as torch's "highest" float32 matmul precision gives;
//    the mma.sync kernel's staging, each thread a (BM/16) x (BN/16)
//    strided patch of the tile.
//
// What bounds it on an H100.  At yi-6b's MLP projection of a 512-token
// prefill (M=512, K=4096, N=11008, bf16) the product is 46.2 GFLOP against
// 105.6 MB of operands: compute-bound (0.047 ms at 989 TFLOP/s dense bf16,
// bytes 0.032 ms).  A 128 x 128 tile re-reads its x and y rows from L2
// for every block, 688 MB in all at that shape, and those copies, not the
// tensor cores, set the pace of the ring.  Left on the table: larger
// tiles (the install region's PPs stop at 128), a TMA store of the tile,
// persistent blocks, and the waves (344 tiles of 128 x 128 on 132 SMs).
// Clusters with multicast TMA halve the L2 reads but not the bytes each
// SM takes in, and their cross-CTA barriers made the kernel slower.

// CUtensorMap and its enums (cuda.h's types only: the encoder comes from
// the runtime, so the library links no libcuda)
#include <cuda.h>

#include "mma.cuh"

namespace {

namespace k8 {
constexpr int THREADS = 256;     // 8 warps
constexpr int WARPS_M = 2;       // bf16 mma.sync: warps along the tile's rows
constexpr int WARPS_N = 4;       //       and along its columns

// Shared-memory bytes of one block of the mma.sync and fp32 kernels: the x
// tile and the y tile, each row padded by 16 bytes.
template <typename T>
constexpr size_t smem_bytes(int bm, int bn, int bk) {
  constexpr int pad = 16 / sizeof(T);
  return sizeof(T) * ((size_t)bm * (bk + pad) + (size_t)bk * (bn + pad));
}
}  // namespace k8

// The wgmma kernel's ring.  kernels/matmul.py's smem_bytes is the same
// formula (the install-time cost model), and chip_smoke.py holds the two
// equal for every tile.
namespace k8w {
constexpr int ALIGN = 1024;             // a swizzle atom's alignment
constexpr int RING_BYTES_PER_WG = 96 * 1024;

__host__ __device__ constexpr int stage_bytes(int bm, int bn, int bk) {
  return 2 * (bm * bk + bk * bn);
}
// as many stages (2 to 8) as fit 96 KB per consumer warpgroup: two
// warpgroups an SM, one block of block_m 128 or two of 64
__host__ __device__ constexpr int stages(int bm, int bn, int bk) {
  return RING_BYTES_PER_WG * (bm / 64) / stage_bytes(bm, bn, bk) < 2 ? 2
         : RING_BYTES_PER_WG * (bm / 64) / stage_bytes(bm, bn, bk) > 8
             ? 8
             : RING_BYTES_PER_WG * (bm / 64) / stage_bytes(bm, bn, bk);
}
// the ring, plus the slack that aligns its base to ALIGN
__host__ __device__ constexpr size_t smem_bytes(int bm, int bn, int bk) {
  return (size_t)stages(bm, bn, bk) * stage_bytes(bm, bn, bk) + ALIGN;
}
// bf16 elements per swizzled row of an operand whose contiguous extent in
// the tile is `extent`: 64 (128-byte swizzle) or 32 (64-byte swizzle)
__host__ __device__ constexpr int atom_width(int extent) {
  return extent < 64 ? extent : 64;
}
// one consumer warpgroup per 64 rows, and the producer warp
__host__ __device__ constexpr int threads(int bm) {
  return bm / 64 * 128 + 32;
}
}  // namespace k8w

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
// bf16 inputs, BM 32 or shapes TMA cannot describe: mma.sync
// ---------------------------------------------------------------------------

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(k8::THREADS)
mm_bf16_mma_kernel(const __nv_bfloat16* __restrict__ x,
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
// bf16 inputs, BM 64 or 128: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// arrive once and expect `bytes` of asynchronous copies on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// wait until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// the box of `map` at (c0 inner, c1 outer) into shared memory at dst,
// completion counted on bar; out-of-bounds elements arrive as zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// wgmma's shared-memory matrix descriptor: the start address and the
// leading and stride byte offsets (given in bytes, stored in 16-byte
// units), and the swizzle (128 or 64 bytes; encoded 1 or 2)
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, int swizzle) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) |
         ((uint64_t)(swizzle == 128 ? 1 : 2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x N, fp32, the warpgroup's fragments) += A (64 x 16, K-major) @
// B (16 x N, MN-major), both bf16 in shared memory through descriptors;
// scale_d 0 would drop d
template <int N>
__device__ void wgmma_bf16(float* d, uint64_t a, uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float* d, uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float* d, uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float* d, uint64_t a,
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// keep the compiler from moving reads or writes of the accumulators across
// the asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// x (M, K) and y (K, N) through their tensor maps (boxes of (atom width,
// BM) and (atom width, BK)); grid (ceil(M / BM), ceil(N / BN)), M fastest.
template <int BM, int BN, int BK>
__global__ void __launch_bounds__(k8w::threads(BM))
mm_bf16_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                     const __grid_constant__ CUtensorMap ty,
                     const float* __restrict__ bias, void* __restrict__ o,
                     int M, int N, int K, int epilogue, int out_bf16) {
  constexpr int STAGES = k8w::stages(BM, BN, BK);
  constexpr int STAGE = k8w::stage_bytes(BM, BN, BK);
  constexpr int X_BYTES = BM * BK * 2;            // x's share of a stage
  constexpr int XW = k8w::atom_width(BK);         // elements per swizzled row
  constexpr int YW = k8w::atom_width(BN);
  constexpr int XSW = XW * 2, YSW = YW * 2;       // bytes per swizzled row
  constexpr int CONSUMERS = BM / 64;
  constexpr int R = BN / 2;                       // accumulators per thread
  static_assert(BM % 64 == 0 && BN % 32 == 0 && BK % 32 == 0, "tile shape");

  extern __shared__ __align__(1024) unsigned char wg_smem[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  unsigned char* ring =
      wg_smem + ((k8w::ALIGN - (smem_addr(wg_smem) & (k8w::ALIGN - 1))) &
                 (k8w::ALIGN - 1));

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int k_tiles = (K + BK - 1) / BK;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);                   // the producer's arrival
      mbar_init(&empty[s], CONSUMERS * 4);      // every consumer warp's
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * CONSUMERS) {
    // producer: one thread keeps the ring full; tile kt waits for the
    // consumers to free tile kt - STAGES from its stage
    if ((threadIdx.x & 31) == 0) {
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        unsigned char* xs = ring + s * STAGE;
        unsigned char* ys = xs + X_BYTES;
        const int k0 = kt * BK;
        mbar_expect_tx(&full[s], STAGE);
#pragma unroll
        for (int a = 0; a < BK / XW; ++a)
          tma_load_2d(xs + a * BM * XSW, &tx, &full[s], k0 + a * XW, m0);
#pragma unroll
        for (int a = 0; a < BN / YW; ++a)
          tma_load_2d(ys + a * BK * YSW, &ty, &full[s], n0 + a * YW, k0);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows wg * 64 .. + 63 of the tile
  const int wg = warp / 4;
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  fence_regs<R>(acc);
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(&full[s], (kt / STAGES) & 1);
    const unsigned char* xs = ring + s * STAGE + wg * 64 * XSW;
    const unsigned char* ys = ring + s * STAGE + X_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int ke = kk * 16;     // the step's first k within the tile
      // x: K-major, atom ke / XW, 32 bytes per step inside a swizzled row,
      // 8-row groups SBO = 8 rows apart
      const uint64_t da = make_desc(xs + (ke / XW) * BM * XSW + (ke % XW) * 2,
                                    16, 8 * XSW, XSW);
      // y: MN-major, 16 k rows per step, 8-row groups SBO apart, the
      // second 64-wide N atom LBO = one atom's BK rows further
      const uint64_t db = make_desc(ys + ke * YSW, BK * YSW, 8 * YSW, YSW);
      wgmma_bf16<BN>(acc, da, db, 1);
    }
    wgmma_commit();
    // this tile's products are done: its stage is free
    wgmma_wait<0>();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);
  }
  fence_regs<R>(acc);

  // fragment i of thread (warp w, lane l): row w * 16 + l / 4 + 8 * (i / 2
  // % 2), column (i / 4) * 8 + (l % 4) * 2 + i % 2; N is a multiple of 8,
  // so a column pair is wholly inside or outside and its store aligned
  const int lane = threadIdx.x & 31;
  const int row0 = m0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int col0 = n0 + (lane & 3) * 2;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + j * 8;
    if (col >= N) continue;
    const float b0 = bias != nullptr ? bias[col] : 0.f;
    const float b1 = bias != nullptr ? bias[col + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      const float v0 = apply_epilogue(acc[4 * j + 2 * h] + b0, epilogue);
      const float v1 = apply_epilogue(acc[4 * j + 2 * h + 1] + b1, epilogue);
      const size_t idx = (size_t)row * N + col;
      if (out_bf16)
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(o) +
                                           idx) = __floats2bfloat162_rn(v0, v1);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(o) + idx) =
            make_float2(v0, v1);
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

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The kernel of an input type: fp32 FMAs for float, mma.sync for bf16.
template <typename T, int BM, int BN, int BK>
struct MmKernel;
template <int BM, int BN, int BK>
struct MmKernel<float, BM, BN, BK> {
  static constexpr auto fn = &mm_f32_kernel<BM, BN, BK>;
};
template <int BM, int BN, int BK>
struct MmKernel<__nv_bfloat16, BM, BN, BK> {
  static constexpr auto fn = &mm_bf16_mma_kernel<BM, BN, BK>;
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

// cuTensorMapEncodeTiled, taken from the driver through the runtime (the
// library links no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a row-major bf16 (outer, inner) matrix read in boxes
// of (box_outer, box_inner) with a `swizzle`-byte swizzle (box_inner * 2
// bytes); out-of-bounds elements read as zeros.
cudaError_t make_map(CUtensorMap* map, const void* base, int inner, int outer,
                     int box_inner, int box_outer, int swizzle) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};  // bytes, of dim 1
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BM, int BN, int BK>
cudaError_t launch_wgmma(const MmArgs& a, cudaStream_t stream) {
  // TMA: 16-byte row strides and bases; grid.y holds the column tiles
  if (a.K % 8 || a.N % 8 || !aligned16(a.x) || !aligned16(a.y) ||
      (a.N + BN - 1) / BN > 65535)
    return cudaErrorInvalidValue;
  constexpr int XW = k8w::atom_width(BK), YW = k8w::atom_width(BN);
  CUtensorMap tx, ty;
  cudaError_t err = make_map(&tx, a.x, a.K, a.M, XW, BM, 2 * XW);
  if (err == cudaSuccess) err = make_map(&ty, a.y, a.N, a.K, YW, BK, 2 * YW);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = k8w::smem_bytes(BM, BN, BK);
  const auto kernel = &mm_bf16_wgmma_kernel<BM, BN, BK>;
  static cudaError_t opted = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (opted != cudaSuccess) return opted;
  const dim3 grid((a.M + BM - 1) / BM, (a.N + BN - 1) / BN);
  kernel<<<grid, k8w::threads(BM), smem, stream>>>(
      tx, ty, a.bias, a.o, a.M, a.N, a.K, a.epilogue, a.out_bf16);
  return cudaGetLastError();
}

// The kernels as repro_matmul reports them in *ran
enum MmKernelId { kF32 = 0, kMma = 1, kWgmma = 2 };

// bf16 tiles with BM >= 64 run the wgmma kernel, every other tile its
// type's kernel; *ran names the kernel launched
template <typename T, int BM, int BN, int BK>
cudaError_t launch_tile(const MmArgs& a, cudaStream_t st, int* ran) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && BM >= 64) {
    *ran = kWgmma;
    return launch_wgmma<BM, BN, BK>(a, st);
  } else {
    *ran = std::is_same_v<T, float> ? kF32 : kMma;
    return launch_mm<T, BM, BN, BK>(a, st);
  }
}

// f(integral_constant BM, BN, BK) for an instantiated tile, else
// cudaErrorInvalidValue
template <int V>
using Int = std::integral_constant<int, V>;

template <typename F>
cudaError_t by_tile(int bm, int bn, int bk, F&& f) {
  auto on_bk = [&](auto BM, auto BN) -> cudaError_t {
    switch (bk) {
      case 32: return f(BM, BN, Int<32>{});
      case 64: return f(BM, BN, Int<64>{});
      case 128: return f(BM, BN, Int<128>{});
      default: return cudaErrorInvalidValue;
    }
  };
  auto on_bn = [&](auto BM) -> cudaError_t {
    switch (bn) {
      case 32: return on_bk(BM, Int<32>{});
      case 64: return on_bk(BM, Int<64>{});
      case 128: return on_bk(BM, Int<128>{});
      default: return cudaErrorInvalidValue;
    }
  };
  switch (bm) {
    case 32: return on_bn(Int<32>{});
    case 64: return on_bn(Int<64>{});
    case 128: return on_bn(Int<128>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t mm_dispatch(int bm, int bn, int bk, const MmArgs& a,
                        cudaStream_t st, int* ran) {
  return by_tile(bm, bn, bk, [&](auto BM, auto BN, auto BK) {
    return launch_tile<T, decltype(BM)::value, decltype(BN)::value,
                       decltype(BK)::value>(a, st, ran);
  });
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y alike); out_bf16: 1 stores
// bfloat16, 0 float32; epilogue: 0 none, 1 gelu (tanh), 2 silu, 3 relu;
// bias: a float32 (N,) vector or null.  (bm, bn, bk) must be an
// instantiated tile, each of 32, 64, 128; a bf16 tile with bm >= 64 runs
// the wgmma kernel and takes K and N multiples of 8 and 16-byte aligned x
// and y only (kernels/matmul.py's route() sends other shapes to bm = 32).
// *ran is set to the kernel launched: 0 mm_f32_kernel, 1
// mm_bf16_mma_kernel, 2 mm_bf16_wgmma_kernel (-1 if none).  Returns the
// launch's cudaError_t (0 = success).  The caller validates shapes and
// devices.
extern "C" int repro_matmul(const void* x, const void* y, const void* bias,
                            void* o, int M, int N, int K, int dtype,
                            int out_bf16, int epilogue, int bm, int bn,
                            int bk, void* stream, int* ran) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int v = dtype == 0 ? 4 : 8;  // elements per 16-byte vector
  const MmArgs a{x, y, static_cast<const float*>(bias), o, M, N, K, epilogue,
                 out_bf16, (int)(K % v == 0 && aligned16(x)),
                 (int)(N % v == 0 && aligned16(y))};
  *ran = -1;
  if (dtype == 0) return mm_dispatch<float>(bm, bn, bk, a, st, ran);
  if (dtype == 1) return mm_dispatch<__nv_bfloat16>(bm, bn, bk, a, st, ran);
  return cudaErrorInvalidValue;
}

// Shared-memory bytes (dynamic) one block of tile (bm, bn, bk) takes.
extern "C" long long repro_matmul_smem_bytes(int dtype, int bm, int bn,
                                             int bk) {
  if (dtype == 1 && bm >= 64) return (long long)k8w::smem_bytes(bm, bn, bk);
  return dtype == 0 ? (long long)k8::smem_bytes<float>(bm, bn, bk)
                    : (long long)k8::smem_bytes<__nv_bfloat16>(bm, bn, bk);
}

// What the card makes of the wgmma instance of tile (bm, bn, bk), bm 64 or
// 128: out[0..4] = registers per thread, local-memory (spill) bytes, the
// dynamic shared memory, resident blocks per SM, stages of the ring.
extern "C" int repro_matmul_wgmma_info(int bm, int bn, int bk, int* out) {
  if (bm < 64) return cudaErrorInvalidValue;
  return by_tile(bm, bn, bk, [&](auto BM, auto BN, auto BK) -> cudaError_t {
    constexpr int M_ = decltype(BM)::value, N_ = decltype(BN)::value,
                  K_ = decltype(BK)::value;
    if constexpr (M_ >= 64) {
      out[4] = k8w::stages(M_, N_, K_);
      return instance_info(&mm_bf16_wgmma_kernel<M_, N_, K_>,
                           k8w::threads(M_), k8w::smem_bytes(M_, N_, K_),
                           out);
    } else {
      return cudaErrorInvalidValue;
    }
  });
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
