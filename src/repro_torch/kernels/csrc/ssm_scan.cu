// K9 selective_scan for Hopper (sm_90a): the Mamba-1 selective scan of
// falcon-mamba-7b.  Plain C interface, bound from Python with ctypes
// (kernels/ssm_scan.py); no PyTorch headers.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py: selective_scan
// (pallas_call :74), with its body _scan_kernel (:32).  Same function, per
// batch entry b, channel d and state n, over t = 0 .. L-1 from h = 0, in
// float32:
//   h[d,n] = exp(dt[t,d] * A[d,n]) * h[d,n] + (dt[t,d] * x[t,d]) * B[t,n]
//   y[t,d] = sum_n C[t,n] * h[d,n] + D[d] * x[t,d]
// x, dt (Bt, L, Di), B, C (Bt, L, N) and D (Di,) all float32 or all bf16,
// A (Di, N) float32; y (Bt, L, Di) in x's type, and on request the final
// state h (Bt, Di, N) float32 (the TPU kernel never returns it; the JAX
// package's plain scan does, and prefill needs it).
//
// What bounds it on an H100.  At falcon-mamba's prefill layer (Bt 1, L
// 512, Di 8192, N 16, bf16) the bytes (x, dt and y, B and C, A and D, the
// final state) are ~25 MB, 0.0075 ms at 3.35 TB/s; but every (t, d, n)
// item needs one exp, 67 M of them, and the SFU gives 16 a clock an SM:
// ~0.016 ms at 132 SMs and 1.98 GHz.  So the floor is the exps, and what
// a kernel pays above it is instructions: the first port (one thread per
// (d, n), 512 dependent steps each, the sum over n a 4-step shuffle
// butterfly per item) issued ~30 instructions an item and ran at 16x the
// byte bound.
//
// Design: a time-parallel chunked scan.  The recurrence is an affine map
// h -> a h + b per step (a = exp(dt A), b = dt x B), and affine maps
// compose associatively, so a warp scans a run of steps in parallel:
//  * a block of 16 warps takes (batch entry, 16 channels): each time row of
//    x, dt and y is then a full 32-byte sector in bf16; warp w owns channel
//    d0 + w;
//  * the block walks the sequence in tiles of `chunk` steps (the SsmChunk
//    region's PP, as the JAX kernel's chunk); lane j of a warp owns I
//    consecutive steps j I .. j I + I - 1 of the tile, I = ceil(chunk /
//    32) rounded up to a power of two (at most 16: a tile longer than 512
//    steps is scanned as consecutive passes of 512);
//  * per state n: each lane composes its steps' maps into one pair (P, S)
//    (P = exp2(A' sum_i dt_i) in one exp, S by I FMAs, keeping each a_i and
//    b_i in registers); a 5-step __shfl_up_sync scan composes the lanes'
//    pairs; the warp's carry h[n] from the previous tile (held by lane n in
//    a register) gives each lane its true h_in; the lane replays its steps
//    from h_in and adds C[t,n] h_t to its steps' y in registers.  So the
//    sum over n is in registers, shuffles cost ~13 per (n, lane) over its
//    I items instead of 4 per item, and an item costs an exp, ~4 FMAs and
//    half a shared load; A' = A log2(e), so the exp is the SFU's
//    ex2.approx.ftz (relative error ~2^-22; exp2f's denormal handling and
//    expf's range reduction only add instructions, and the float32
//    tolerance against the plain scan is 2e-4);
//  * staging: the tile's rows arrive by 16-byte cp.async copies in their
//    natural layout (x, dt: 16 channels a row; B, C: one contiguous run)
//    while the previous tile is scanned; then the block transposes them
//    once into lane-major float rows (a channel's x or dt, a state's B or
//    C: lane j's I steps contiguous, lanes 4 mod 8 floats apart for I >= 8,
//    so 16-byte reads by 8 lanes at a time fall in distinct banks; rows 4
//    mod 32 floats apart, so the transposing writes collide at most
//    2-way), a thread taking 8 channels (states) of a step by one 16-byte
//    read.  Stored time-major, B[t, n] would fall in one bank for every
//    lane.  A lane reads its x and dt once a tile and its B and C once per
//    state as vector loads.  y goes back through the x rows and leaves in
//    16-byte stores along Di.  Shapes the 16-byte copies cannot take (Di or
//    N rows not a multiple of 16 bytes, unaligned tensors) are staged and
//    stored by plain loads and stores instead, same layout;
//  * persistent blocks: the grid is as many blocks as the card holds at
//    once (one an SM at I = 16), each walking work items (batch entry, 16
//    channels) in steps of the grid, so the next item's first tile is
//    copied while the last tile of the current one is scanned;
//  * the final state h[d, :] is the carry after an item's last tile.
// Two alternatives measured on an H100 lost at falcon-mamba's prefill
// shape (Bt 1): a sequential kernel, a thread per channel and 4 states
// walking the steps in order with no scan, has too few warps there (it
// wins at Bt 4); and element-wise transposes, which left the staging a
// large share of the time, hence the 16-byte ones.
// `chunk` trades the scan's fixed cost (larger I: fewer shuffles an item)
// against shared memory and registers (5 I floats a lane), hence blocks an
// SM; ragged tiles and channels are zero-filled, and a zero step (dt = 0)
// is the identity map, so nothing is masked inside the scan.

#include <climits>

#include "mma.cuh"

namespace {

namespace ssm {
constexpr int CH = 16;                // channels per block: one warp each
constexpr int THREADS = CH * 32;
constexpr int IMAX = 16;              // steps a lane owns, at most
constexpr int WMAX = 32 * IMAX;       // steps of one warp pass
}  // namespace ssm

// steps a lane owns for a tile of `chunk` steps: a power of two
__host__ __device__ constexpr int items_for(int chunk) {
  const int w = chunk < ssm::WMAX ? chunk : ssm::WMAX;
  const int i = (w + 31) / 32;
  return i <= 1 ? 1 : i <= 2 ? 2 : i <= 4 ? 4 : i <= 8 ? 8 : 16;
}

// floats from one lane's steps to the next lane's in a lane-major row: a
// multiple of 4 that is 4 mod 8 (16-byte reads by 8 lanes hit 8 distinct
// bank quads) for I >= 4; I for I < 4 (the lanes' reads are contiguous)
__host__ __device__ constexpr int lane_stride(int items) {
  return items < 4 ? items : ((items / 4) % 2 ? items : items + 4);
}

// floats of one lane-major row: the lanes that own steps of a pass, padded
// to 4 mod 32
__host__ __device__ constexpr int row_floats(int chunk) {
  const int w = chunk < ssm::WMAX ? chunk : ssm::WMAX;
  const int items = items_for(chunk);
  const int f = (w + items - 1) / items * lane_stride(items);
  return f + (36 - f % 32) % 32;
}

__host__ __device__ constexpr long long round16(long long bytes) {
  return (bytes + 15) / 16 * 16;
}

// Shared memory of one block: the lane-major float rows (x and dt of the
// 16 channels, B and C of the n states), then the raw tile in the input
// type (x, dt: chunk x 16; B, C: chunk x n), each region 16-byte aligned.
__host__ __device__ constexpr long long ssm_smem_bytes(int n, int chunk,
                                                       int elem) {
  return 4LL * (2 * ssm::CH + 2 * n) * row_floats(chunk) +
         2 * round16((long long)chunk * ssm::CH * elem) +
         2 * round16((long long)chunk * n * elem);
}

template <int I>
__device__ __forceinline__ void load_items(const float* p, float (&v)[I]) {
  if constexpr (I >= 4) {
#pragma unroll
    for (int i = 0; i < I; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x; v[i + 1] = t.y; v[i + 2] = t.z; v[i + 3] = t.w;
    }
  } else if constexpr (I == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = p[0];
  }
}

template <int I>
__device__ __forceinline__ void store_items(float* p, const float (&v)[I]) {
  if constexpr (I >= 4) {
#pragma unroll
    for (int i = 0; i < I; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else if constexpr (I == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// 8 consecutive elements (16-byte aligned) -> fp32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  load_f32<8>(p, v);
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  load_f32<4>(p, v);
  load_f32<4>(p + 4, v + 4);
}

// 8 fp32 values -> 8 consecutive elements (16-byte aligned)
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  uint4 t;
  t.x = pack_bf16(v[0], v[1]);
  t.y = pack_bf16(v[2], v[3]);
  t.z = pack_bf16(v[4], v[5]);
  t.w = pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = t;
}
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// 2^x by the SFU's ex2.approx (relative error ~2^-22; a result below 2^-126
// flushes to 0, a decay of no weight here)
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Persistent blocks (as many as the card holds at once) walk the work
// items, (batch entry, group of 16 channels), item = batch * groups +
// group, in steps of gridDim.x; I = items_for(chunk); `vec`: the 16-byte
// copies, loads and stores may move the rows (host-checked alignment).
// (two blocks an SM for bf16 at I <= 4: 64 registers, which float32's
// staging would spill)
template <typename T, int I>
__global__ void __launch_bounds__(ssm::THREADS,
                                  I <= 4 && sizeof(T) == 2 ? 2 : 1)
ssm_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, const T* __restrict__ dskip,
                T* __restrict__ y, float* __restrict__ h_out, int len, int di,
                int n_state, int log_n, int chunk, int vec, int n_items) {
  using namespace ssm;
  constexpr int STRIDE = lane_stride(I);
  constexpr int E = 16 / (int)sizeof(T);     // elements of a 16-byte copy
  const int rowf = row_floats(chunk);
  const int w_max = min(chunk, WMAX);
  const int groups = (di + CH - 1) / CH;
  const int n_tiles = (len + chunk - 1) / chunk;

  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);   // [CH][rowf]: x, then y
  float* dts = xs + CH * rowf;                  // [CH][rowf]
  float* bs = dts + CH * rowf;                  // [n][rowf]
  float* cs = bs + n_state * rowf;              // [n][rowf]
  unsigned char* raw = reinterpret_cast<unsigned char*>(cs + n_state * rowf);
  const long long rx = round16((long long)chunk * CH * sizeof(T));
  const long long rb = round16((long long)chunk * n_state * sizeof(T));
  T* xr = reinterpret_cast<T*>(raw);            // [chunk][CH]
  T* dtr = reinterpret_cast<T*>(raw + rx);      // [chunk][CH]
  T* br = reinterpret_cast<T*>(raw + 2 * rx);   // [chunk][n]
  T* cr = reinterpret_cast<T*>(raw + 2 * rx + rb);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int ch = tid >> 5;

  // the raw rows of item `it`'s `steps` steps from t0, as they lie in
  // memory: x and dt 16 channels a row, B and C one run
  auto stage = [&](int it, int t0, int steps) {
    const int bb = it / groups;
    const int dg = (it - bb * groups) * CH;
    const size_t xoff = ((size_t)bb * len + t0) * di + dg;
    const size_t boff = ((size_t)bb * len + t0) * n_state;
    if (vec) {
      constexpr int XC = CH / E;               // copies of a 16-channel row
      for (int i = tid; i < steps * XC; i += THREADS) {
        const int t = i / XC;
        const int c = (i - t * XC) * E;
        const bool in = dg + c < di;           // Di % E == 0 under vec
        const size_t off = in ? xoff + (size_t)t * di + c : 0;
        cp_async16(smem_addr(xr + t * CH + c), x + off, in ? 16 : 0);
        cp_async16(smem_addr(dtr + t * CH + c), dt + off, in ? 16 : 0);
      }
      for (int i = tid; i < steps * n_state / E; i += THREADS) {
        cp_async16(smem_addr(br + i * E), bm + boff + i * E, 16);
        cp_async16(smem_addr(cr + i * E), cm + boff + i * E, 16);
      }
      cp_async_commit();
    } else {
      for (int i = tid; i < steps * CH; i += THREADS) {
        const int t = i / CH;
        const int c = i - t * CH;
        const bool in = dg + c < di;
        const size_t off = xoff + (size_t)t * di + c;
        xr[i] = in ? x[off] : from_float<T>(0.f);
        dtr[i] = in ? dt[off] : from_float<T>(0.f);
      }
      for (int i = tid; i < steps * n_state; i += THREADS) {
        br[i] = bm[boff + i];
        cr[i] = cm[boff + i];
      }
    }
  };
  // position of pass step s in a lane-major row
  auto pos = [](int s) { return (s / I) * STRIDE + (s & (I - 1)); };

  int item = blockIdx.x;
  int k = 0;                          // the tile of the item
  float a2_mine = 0.f, carry_mine = 0.f, dd = 0.f;
  if (item < n_items) stage(item, 0, min(chunk, len));
  while (item < n_items) {
    const int batch = item / groups;
    const int d0 = (item - batch * groups) * CH;
    const int d = d0 + ch;
    const bool live = d < di;
    const size_t row0 = (size_t)batch * len;   // first time row of the entry
    if (k == 0) {
      // lane n holds A[d, n] log2(e) and the carry h[d, n]
      dd = live ? to_float(dskip[d]) : 0.f;
      a2_mine = live && lane < n_state
                    ? a[(size_t)d * n_state + lane] * kLog2e : 0.f;
      carry_mine = 0.f;
    }
    const int t0 = k * chunk;
    const int steps = min(chunk, len - t0);
    if (vec) cp_async_wait<0>();
    __syncthreads();   // the tile has landed; the last pass's y has left
    for (int p0 = 0; p0 < steps; p0 += w_max) {
      const int sp = min(w_max, steps - p0);
      const int fill = (sp + I - 1) / I * I;   // steps of the active lanes
      if (p0) __syncthreads();   // the previous pass's y has left
      // transpose the pass into lane-major float rows, 8 channels (states)
      // of a step a thread; steps past the tile are zeros, and dt = 0 is
      // the identity map
      for (int i = tid; i < fill * 2; i += THREADS) {
        const int s = i >> 1;
        const int c0 = (i & 1) * 8;
        float xv[8], dv[8];
        if (s < sp) {
          load8(xr + (p0 + s) * CH + c0, xv);
          load8(dtr + (p0 + s) * CH + c0, dv);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) xv[j] = dv[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          xs[(c0 + j) * rowf + pos(s)] = xv[j];
          dts[(c0 + j) * rowf + pos(s)] = dv[j];
        }
      }
      if (n_state >= 8) {
        const int per = n_state >> 3;          // 8-state runs of a step
        for (int i = tid; i < fill * per; i += THREADS) {
          const int s = i / per;
          const int n0 = (i - s * per) * 8;
          float bv[8], cv[8];
          if (s < sp) {
            load8(br + (p0 + s) * n_state + n0, bv);
            load8(cr + (p0 + s) * n_state + n0, cv);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) bv[j] = cv[j] = 0.f;
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            bs[(n0 + j) * rowf + pos(s)] = bv[j];
            cs[(n0 + j) * rowf + pos(s)] = cv[j];
          }
        }
      } else {
        for (int i = tid; i < fill * n_state; i += THREADS) {
          const int s = i >> log_n;
          const int n = i - (s << log_n);
          const bool in = s < sp;
          const int t = (p0 + s) * n_state + n;
          bs[n * rowf + pos(s)] = in ? to_float(br[t]) : 0.f;
          cs[n * rowf + pos(s)] = in ? to_float(cr[t]) : 0.f;
        }
      }
      __syncthreads();
      // the raw buffer is free once the tile's last pass is transposed:
      // bring the next tile (of this item, or the block's next item's
      // first) while this one is scanned
      if (p0 + w_max >= steps) {
        if (k + 1 < n_tiles)
          stage(item, t0 + chunk, min(chunk, len - t0 - chunk));
        else if (item + (int)gridDim.x < n_items)
          stage(item + gridDim.x, 0, min(chunk, len));
      }

      // the warp's scan of its channel over the pass; lanes past the
      // pass's steps hold identity maps and read nothing
      const bool act = lane * I < sp;
      const int lp = lane * STRIDE;
      float dtv[I], dtx[I], yv[I];
      float sdt = 0.f;
      if (act) {
        load_items(dts + ch * rowf + lp, dtv);
        load_items(xs + ch * rowf + lp, dtx);
      } else {
#pragma unroll
        for (int i = 0; i < I; ++i) dtv[i] = dtx[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < I; ++i) {
        yv[i] = dd * dtx[i];
        dtx[i] *= dtv[i];
        sdt += dtv[i];
      }
#pragma unroll 1
      for (int n = 0; n < n_state; ++n) {
        const float a2 = __shfl_sync(kFull, a2_mine, n);
        const float carry = __shfl_sync(kFull, carry_mine, n);
        float av[I], bv[I];
        if (act) {
          load_items(bs + n * rowf + lp, bv);
        } else {
#pragma unroll
          for (int i = 0; i < I; ++i) bv[i] = 0.f;
        }
        // the lane's steps composed: h -> P h + S
        float s_acc = 0.f;
#pragma unroll
        for (int i = 0; i < I; ++i) {
          av[i] = exp2_sfu(dtv[i] * a2);
          bv[i] *= dtx[i];
          s_acc = fmaf(av[i], s_acc, bv[i]);
        }
        float p_acc = exp2_sfu(sdt * a2);
        // inclusive scan over the lanes: lane j holds lanes 0 .. j composed
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const float pp = __shfl_up_sync(kFull, p_acc, off);
          const float sp_ = __shfl_up_sync(kFull, s_acc, off);
          if (lane >= off) {
            s_acc = fmaf(p_acc, sp_, s_acc);
            p_acc *= pp;
          }
        }
        const float h_end = fmaf(p_acc, carry, s_acc);   // after lane's steps
        float h = __shfl_up_sync(kFull, h_end, 1);
        if (lane == 0) h = carry;
        float cv[I];
        if (act) {
          load_items(cs + n * rowf + lp, cv);
        } else {
#pragma unroll
          for (int i = 0; i < I; ++i) cv[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < I; ++i) {
          h = fmaf(av[i], h, bv[i]);
          yv[i] = fmaf(cv[i], h, yv[i]);
        }
        const float next = __shfl_sync(kFull, h_end, 31);
        if (lane == n) carry_mine = next;
      }
      // y through the warp's own x row (each lane rewrites only its steps)
      if (act) store_items(xs + ch * rowf + lp, yv);
      __syncthreads();
      if (vec) {     // 8 channels of a step a thread, 16-byte stores
        for (int i = tid; i < sp * 2; i += THREADS) {
          const int s = i >> 1;
          const int c0 = (i & 1) * 8;
          float v[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = xs[(c0 + j) * rowf + pos(s)];
          T* out = y + (row0 + t0 + p0 + s) * di + d0 + c0;
          if (d0 + c0 + 8 <= di) {
            store8(out, v);
          } else {   // float32 rows end on 4 channels: Di % 4 == 0 only
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (d0 + c0 + j < di) out[j] = from_float<T>(v[j]);
          }
        }
      } else {
        for (int i = tid; i < sp * CH; i += THREADS) {
          const int s = i / CH;
          const int c = i - s * CH;
          if (d0 + c < di)
            y[(row0 + t0 + p0 + s) * di + d0 + c] =
                from_float<T>(xs[c * rowf + pos(s)]);
        }
      }
    }
    if (k + 1 < n_tiles) {
      ++k;
    } else {            // the item's final state is the carry
      if (h_out != nullptr && live && lane < n_state)
        h_out[((size_t)batch * di + d) * n_state + lane] = carry_mine;
      k = 0;
      item += gridDim.x;
    }
  }
}

template <typename T, int I>
cudaError_t launch_ssm(const void* x, const void* dt, const void* a,
                       const void* b, const void* c, const void* d, void* y,
                       void* h, int batch, int len, int di, int n,
                       int chunk, int vec, cudaStream_t stream) {
  const long long smem = ssm_smem_bytes(n, chunk, (int)sizeof(T));
  if (smem > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = ssm_scan_kernel<T, I>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, ssm::THREADS, (size_t)smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  const int n_items = (di + ssm::CH - 1) / ssm::CH * batch;
  kernel<<<min(n_items, per_sm * sms), ssm::THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<const T*>(d), static_cast<T*>(y),
      static_cast<float*>(h), len, di, n, log_n, chunk, vec, n_items);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_items(const void* x, const void* dt, const void* a,
                           const void* b, const void* c, const void* d,
                           void* y, void* h, int batch, int len, int di,
                           int n, int chunk, cudaStream_t st) {
  const auto addr = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p);
  };
  const int vec = (addr(x) | addr(dt) | addr(b) | addr(c) | addr(y)) % 16 == 0 &&
                  (long long)di * sizeof(T) % 16 == 0 &&
                  n * sizeof(T) % 16 == 0;
  switch (items_for(chunk)) {
    case 1: return launch_ssm<T, 1>(x, dt, a, b, c, d, y, h, batch, len, di, n, chunk, vec, st);
    case 2: return launch_ssm<T, 2>(x, dt, a, b, c, d, y, h, batch, len, di, n, chunk, vec, st);
    case 4: return launch_ssm<T, 4>(x, dt, a, b, c, d, y, h, batch, len, di, n, chunk, vec, st);
    case 8: return launch_ssm<T, 8>(x, dt, a, b, c, d, y, h, batch, len, di, n, chunk, vec, st);
    default: return launch_ssm<T, 16>(x, dt, a, b, c, d, y, h, batch, len, di, n, chunk, vec, st);
  }
}

}  // namespace

// Shared memory one block takes for d_state n, chunk and an input type of
// elem bytes (the formula of kernels/ssm_scan.py's smem_bytes and of the
// SsmChunk cost model).
extern "C" long long repro_ssm_scan_smem_bytes(int n, int chunk, int elem) {
  return ssm_smem_bytes(n, chunk, elem);
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
      chunk > len || n < 1 || n > 32 || (n & (n - 1)))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_items<float>(x, dt, a, b, c, d, y, h, batch, len, di, n, chunk, st);
    case 1: return dispatch_items<__nv_bfloat16>(x, dt, a, b, c, d, y, h, batch, len, di, n, chunk, st);
    default: return cudaErrorInvalidValue;
  }
}
