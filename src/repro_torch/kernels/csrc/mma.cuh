// Helpers of the port's tensor-core kernels (flash_attention.cu's K1,
// paged_prefill.cu's K4/K5b/K6c/K6d and paged_decode.cu's K3/K6a): on the
// device, 16-byte asynchronous copies from device to shared memory,
// ldmatrix fragment loads, the bf16 mma.sync with fp32 accumulators, bf16
// packing and the exact widening of int8 codes to bf16; on the host, what
// the card makes of a kernel instance.  Each .cu file builds into its own
// library, so everything here has internal linkage; kernels/build.py
// hashes every header with each source, so a change here rebuilds all.
#pragma once

#include "common.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

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

// Chunk c (16 bytes) of a padded instance's row into shared memory at dst
// (16-byte aligned): the row's bytes c * 16 .. c * 16 + 15 that lie below
// its end (rb bytes from row, or none when !in), zeros after.  Every row of
// the tensor starts at a multiple of rb from a 16-byte aligned base, so a
// 16-byte cp.async takes the chunk where rb % 16 == 0, four 4-byte ones
// where rb % 4 == 0 (a bf16 row of d = 100: 200 bytes), and plain loads and
// stores otherwise (an odd bf16 d); the copies' zero-fill pads past the end.
// `base` is any valid address, named by a copy that reads nothing.
__device__ __forceinline__ void cp_async16_part(void* dst, const void* row,
                                                int c, int rb, bool in,
                                                const void* base) {
  const int n = in ? max(0, min(16, rb - c * 16)) : 0;
  const unsigned char* src = static_cast<const unsigned char*>(row) + c * 16;
  const uint32_t sa = smem_addr(dst);
  if (rb % 16 == 0) {
    cp_async16(sa, n ? static_cast<const void*>(src) : base, n);
  } else if (rb % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int ni = max(0, min(4, n - 4 * i));
      cp_async4(sa + 4 * i, ni ? static_cast<const void*>(src + 4 * i) : base,
                ni);
    }
  } else {
    unsigned char* out = static_cast<unsigned char*>(dst);
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i] = i < n ? src[i] : 0;
  }
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

// The wide instances' Q.K^T (common.cuh): the NS warps of one slab and one
// key set (a group, meeting at named barrier `bar`, 1 ..) each hold in s
// their slice's partial sums in the mma's fragment layout.  Each stores its
// part at buf + slice * NT * 128 (NS * NT * 128 floats, lane-major, so a
// store or load of the warp is one conflict-free row), the group meets,
// and every warp sums the NS parts in slice order 0, 1, ..: all hold the
// same S, bit for bit.  buf may be rewritten only after every warp of the
// group has passed a later barrier (a caller that reuses it at the next
// key step without a block barrier between keeps two and alternates).
template <int NS, int NT>
__device__ __forceinline__ void sum_slices(float (&s)[NT][4], float* buf,
                                           int slice, int lane, int bar) {
  float* mine = buf + slice * (NT * 128);
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mine[(n * 4 + e) * 32 + lane] = s[n][e];
  asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(NS * 32) : "memory");
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = (n * 4 + e) * 32 + lane;
      float x = buf[i];
#pragma unroll
      for (int k = 1; k < NS; ++k) x += buf[k * (NT * 128) + i];
      s[n][e] = x;
    }
}

// What the card makes of one kernel instance launched with `threads`
// threads and `smem` bytes of dynamic shared memory: out[0..3] =
// registers per thread, local-memory (spill) bytes, the shared memory,
// resident blocks per SM.
template <typename Kernel>
cudaError_t instance_info(Kernel kern, int threads, size_t smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kern);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return cudaSuccess;
}

}  // namespace
