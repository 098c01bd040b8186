// K9 selective_scan for Hopper (sm_90a): the Mamba-1 selective scan of
// falcon-mamba-7b.  Plain C interface, bound from Python with ctypes
// (kernels/ssm_scan.py); no PyTorch headers.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py: selective_scan,
// with its body _scan_kernel.  Same function, per batch entry b, channel d
// and state n, over t = 0 .. L-1 from h = 0, in float32:
//   h[d,n] = exp(dt[t,d] * A[d,n]) * h[d,n] + (dt[t,d] * x[t,d]) * B[t,n]
//   y[t,d] = sum_n C[t,n] * h[d,n] + D[d] * x[t,d]
// x, dt (Bt, L, Di), B, C (Bt, L, N) and D (Di,) all float32 or all bf16,
// A (Di, N) float32; y (Bt, L, Di) in x's type, and on request the final
// state h (Bt, Di, N) float32 (the TPU kernel never returns it; the JAX
// package's plain scan does, and prefill needs it).
//
// Design.  The TPU kernel holds the whole (Di, N) state plane in VMEM and
// walks `chunk` time steps per sequential grid step.  Here the (d, n)
// pairs are spread over threads instead: one thread per pair holds h[d,n]
// in a register, a block of 256 threads covers 256 / N channels (16 at
// N = 16, so falcon-mamba's Di = 8192 gives 512 blocks for 132 SMs), and
// the sum over n is a butterfly of __shfl_xor_sync over the N lanes of a
// channel, which sit in one warp.  The time loop runs inside the block in
// chunks of `chunk` steps (the install-time PP of the SsmChunk region):
// the block stages the chunk's x and dt columns (coalesced along Di) and
// its B and C rows (shared by all channels: loaded once per block, not per
// thread) in shared memory as float32, runs the recurrence over the chunk,
// and writes the chunk's y, staged in shared memory too, coalesced along
// Di.  So `chunk` trades shared memory, hence blocks per SM, against load
// and barrier rounds.  The last chunk is masked, nothing is padded.  expf,
// not __expf: the float32 tolerance against the plain scan is 2e-4.
//
// What bounds it on an H100: latency, for now.  The work is L dependent
// steps per thread, a few operations each, while the bytes (x, dt and y,
// B and C, A and D, the final state) are ~25 MB at B = 1, L = 512,
// Di = 8192 in bf16, 7.5 us at 3.35 TB/s.  A chunked parallel scan over L
// and cp.async/TMA double-buffering of the staging are later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Shared memory of one block: x, dt and y staging (chunk x channels) and
// B and C staging (chunk x N), all float32.
__host__ __device__ constexpr long long ssm_smem_bytes(int n, int chunk) {
  return 4LL * chunk * (3LL * (kThreads / n) + 2LL * n);
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, const T* __restrict__ dskip,
                T* __restrict__ y, float* __restrict__ h_out, int len,
                int di, int chunk) {
  constexpr int kChannels = kThreads / N;
  extern __shared__ float smem[];
  float* xs = smem;                       // chunk x kChannels
  float* dts = xs + chunk * kChannels;    // chunk x kChannels
  float* ys = dts + chunk * kChannels;    // chunk x kChannels
  float* bs = ys + chunk * kChannels;     // chunk x N
  float* cs = bs + chunk * N;             // chunk x N

  const int batch = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int ch = threadIdx.x / N, n = threadIdx.x % N;
  const int d = d0 + ch;
  const bool live = d < di;
  const float an = live ? a[(size_t)d * N + n] : 0.0f;
  const float dd = live ? to_float(dskip[d]) : 0.0f;
  const size_t row0 = (size_t)batch * len;   // first time row of this entry
  float h = 0.0f;

  for (int t0 = 0; t0 < len; t0 += chunk) {
    const int steps = min(chunk, len - t0);
    for (int i = threadIdx.x; i < steps * kChannels; i += kThreads) {
      const int t = i / kChannels, c = d0 + i % kChannels;
      const size_t off = (row0 + t0 + t) * di + c;
      xs[i] = c < di ? to_float(x[off]) : 0.0f;
      dts[i] = c < di ? to_float(dt[off]) : 0.0f;
    }
    // B and C rows of the chunk are contiguous: (row0 + t0) * N onwards
    const size_t boff = (row0 + t0) * N;
    for (int i = threadIdx.x; i < steps * N; i += kThreads) {
      bs[i] = to_float(bm[boff + i]);
      cs[i] = to_float(cm[boff + i]);
    }
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      const float xt = xs[t * kChannels + ch], dtt = dts[t * kChannels + ch];
      h = expf(dtt * an) * h + (dtt * xt) * bs[t * N + n];
      float part = h * cs[t * N + n];
#pragma unroll
      for (int off = N / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(kFull, part, off);
      if (n == 0) ys[t * kChannels + ch] = part + dd * xt;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < steps * kChannels; i += kThreads) {
      const int t = i / kChannels, c = d0 + i % kChannels;
      if (c < di) y[(row0 + t0 + t) * di + c] = from_float<T>(ys[i]);
    }
    // the next chunk's staging writes xs, dts, bs and cs only, which no
    // thread reads after the barrier above; ys is written again only
    // after the next chunk's first barrier
  }
  if (h_out != nullptr && live)
    h_out[((size_t)batch * di + d) * N + n] = h;
}

template <typename T, int N>
cudaError_t launch_ssm(const void* x, const void* dt, const void* a,
                       const void* b, const void* c, const void* d, void* y,
                       void* h, int batch, int len, int di, int chunk,
                       cudaStream_t stream) {
  constexpr int kChannels = kThreads / N;
  const long long smem = ssm_smem_bytes(N, chunk);
  auto kernel = ssm_scan_kernel<T, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((di + kChannels - 1) / kChannels, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const T*>(d), static_cast<T*>(y),
      static_cast<float*>(h), len, di, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(int n, const void* x, const void* dt, const void* a,
                       const void* b, const void* c, const void* d, void* y,
                       void* h, int batch, int len, int di, int chunk,
                       cudaStream_t st) {
  switch (n) {
    case 1: return launch_ssm<T, 1>(x, dt, a, b, c, d, y, h, batch, len, di, chunk, st);
    case 2: return launch_ssm<T, 2>(x, dt, a, b, c, d, y, h, batch, len, di, chunk, st);
    case 4: return launch_ssm<T, 4>(x, dt, a, b, c, d, y, h, batch, len, di, chunk, st);
    case 8: return launch_ssm<T, 8>(x, dt, a, b, c, d, y, h, batch, len, di, chunk, st);
    case 16: return launch_ssm<T, 16>(x, dt, a, b, c, d, y, h, batch, len, di, chunk, st);
    case 32: return launch_ssm<T, 32>(x, dt, a, b, c, d, y, h, batch, len, di, chunk, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Shared memory one block takes for d_state n and chunk (the formula of
// kernels/ssm_scan.py's smem_bytes and of the SsmChunk cost model).
extern "C" long long repro_ssm_scan_smem_bytes(int n, int chunk) {
  return ssm_smem_bytes(n, chunk);
}

// x, dt (batch, len, di); a (di, n) float32; b, c (batch, len, n); d (di,);
// y (batch, len, di); h (batch, di, n) float32 or null (no final state).
// dtype: 0 float32, 1 bf16 (x, dt, b, c, d and y).  n is a power of two up
// to 32; 1 <= chunk <= len.  Returns the launch's cudaError_t (0 = success).
extern "C" int repro_ssm_scan(const void* x, const void* dt, const void* a,
                              const void* b, const void* c, const void* d,
                              void* y, void* h, int batch, int len, int di,
                              int n, int chunk, int dtype, void* stream) {
  if (batch < 1 || batch > 65535 || len < 1 || di < 1 || chunk < 1 ||
      chunk > len)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_n<float>(n, x, dt, a, b, c, d, y, h, batch, len, di, chunk, st);
    case 1: return dispatch_n<__nv_bfloat16>(n, x, dt, a, b, c, d, y, h, batch, len, di, chunk, st);
    default: return cudaErrorInvalidValue;
  }
}
