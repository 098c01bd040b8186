// K7 fdm_stress for Hopper (sm_90a): the seismic FDM stress update of the
// paper's Sample 8 (ppOpen-APPL/FDM).  Plain C interface, bound from Python
// with ctypes (kernels/fdm_stress.py); no PyTorch headers.
//
// Replaces the TPU kernel src/repro/kernels/fdm_stress.py: fdm_stress /
// _call, with its _fused_kernel, _normal_kernel and _shear_kernel.  Same
// function, point by point over an (nx, ny, nz) float32 grid:
//   QG  = absx[i] * absy[j] * absz[k] * q
//   sxx, syy, szz   (the normal part: lam, rig, dxvx, dyvy, dzvz)
//   sxy, sxz, syz   (the shear part: rig at the point and at its i+1, j+1,
//                    k+1, (i+1, j+1), (i+1, k+1), (j+1, k+1) neighbours,
//                    clamped at the far edges, and six velocity derivatives)
// each new stress = (old + (...) * dt) * QG, in the reference's order of
// operations.  Divisions stay IEEE (the library is built without
// --use_fast_math).
//
// Design.  The TPU wrapper writes six shifted copies of rig and a QG plane
// to HBM before its kernel, because a Pallas block cannot gather.  Here
// each thread reads rig at its clamped neighbours itself (the rows a block
// reads overlap its neighbours', so these are L1/L2 hits) and forms QG from
// q and the three abs vectors, so nothing is materialised.  One block owns
// one (bx, by, bz) tile of the grid (the PPs of the Sample 8 region) and
// its threads walk the tile's points with z fastest, so a warp reads
// consecutive addresses; a tile larger than the block (8 x 8 x 128 is
// 8,192 points) gives each thread several points along z.
// Variants (the paper's loop fusion / split, SplitPointCopyDef): "fused"
// is one launch that writes all six outputs; "split" is two launches, the
// normal part and then the shear part, each recomputing QG from q and the
// abs vectors, so rig and q are read twice.
//
// What bounds it on an H100: bytes.  The fused launch reads 18 grid arrays
// and writes 6 (a few FLOPs per byte); split moves 26.  At a 256^3
// subdomain that is 1.61 GB (0.481 ms at 3.35 TB/s) and 1.745 GB
// (0.521 ms).

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;

enum Part { kFused = 0, kNormal = 1, kShear = 2 };

// Pointers in the order of kernels/fdm_stress.py's ARRAYS + STATE + outputs.
struct FdmArgs {
  const float* lam;
  const float* rig;
  const float* q;
  const float* absx;
  const float* absy;
  const float* absz;
  const float* d[9];  // dxvx dyvy dzvz dxvy dyvx dxvz dzvx dyvz dzvy
  const float* s[6];  // sxx syy szz sxy sxz syz, the state read
  float* o[6];        // the same six, written
};

template <int PART>
__global__ void __launch_bounds__(kMaxThreads)
fdm_stress_kernel(const FdmArgs a, int nx, int ny, int nz, int bx, int by,
                  int bz, float dt) {
  const int tiles_z = (nz + bz - 1) / bz, tiles_y = (ny + by - 1) / by;
  const int tile = blockIdx.x;
  const int tz = tile % tiles_z, ty = (tile / tiles_z) % tiles_y;
  const int tx = tile / (tiles_z * tiles_y);
  const int npts = bx * by * bz;
  const size_t sy = nz, sx = (size_t)ny * nz;  // strides of j and i
  for (int p = threadIdx.x; p < npts; p += blockDim.x) {
    const int k = tz * bz + p % bz;
    const int j = ty * by + (p / bz) % by;
    const int i = tx * bx + p / (bz * by);
    if (i >= nx || j >= ny || k >= nz) continue;
    const size_t idx = i * sx + j * sy + k;
    const float rm = a.rig[idx];
    // SplitPointCopyDef: each launch forms QG itself
    const float qg = a.absx[i] * a.absy[j] * a.absz[k] * a.q[idx];
    if (PART != kShear) {
      const float dxvx = a.d[0][idx], dyvy = a.d[1][idx], dzvz = a.d[2][idx];
      const float rm2 = rm + rm;
      const float rltheta = (dxvx + dyvy + dzvz) * a.lam[idx];
      a.o[0][idx] = (a.s[0][idx] + (rltheta + rm2 * dxvx) * dt) * qg;
      a.o[1][idx] = (a.s[1][idx] + (rltheta + rm2 * dyvy) * dt) * qg;
      a.o[2][idx] = (a.s[2][idx] + (rltheta + rm2 * dzvz) * dt) * qg;
    }
    if (PART != kNormal) {
      // neighbours at i+1, j+1, k+1, clamped to the last plane
      const size_t di = i + 1 < nx ? sx : 0, dj = j + 1 < ny ? sy : 0;
      const size_t dk = k + 1 < nz ? 1 : 0;
      const float stmp1 = 1.0f / rm;
      const float stmp2 = 1.0f / a.rig[idx + di];
      const float stmp4 = 1.0f / a.rig[idx + dk];
      const float stmp3 = stmp1 + stmp2;
      const float rmaxy =
          4.0f / (stmp3 + 1.0f / a.rig[idx + dj] + 1.0f / a.rig[idx + di + dj]);
      const float rmaxz = 4.0f / (stmp3 + stmp4 + 1.0f / a.rig[idx + di + dk]);
      const float rmayz = 4.0f / (stmp3 + stmp4 + 1.0f / a.rig[idx + dj + dk]);
      a.o[3][idx] = (a.s[3][idx] + (rmaxy * (a.d[3][idx] + a.d[4][idx])) * dt) * qg;
      a.o[4][idx] = (a.s[4][idx] + (rmaxz * (a.d[5][idx] + a.d[6][idx])) * dt) * qg;
      a.o[5][idx] = (a.s[5][idx] + (rmayz * (a.d[7][idx] + a.d[8][idx])) * dt) * qg;
    }
  }
}

template <int PART>
cudaError_t launch_fdm(const FdmArgs& a, int nx, int ny, int nz, int bx,
                       int by, int bz, float dt, cudaStream_t stream) {
  const long long tiles = (long long)((nx + bx - 1) / bx) *
                          ((ny + by - 1) / by) * ((nz + bz - 1) / bz);
  const int npts = bx * by * bz;
  const int threads = npts >= kMaxThreads ? kMaxThreads : (npts + 31) / 32 * 32;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  fdm_stress_kernel<PART><<<(unsigned)tiles, threads, 0, stream>>>(
      a, nx, ny, nz, bx, by, bz, dt);
  return cudaGetLastError();
}

}  // namespace

// ptrs: 27 device pointers, float32, in the order lam, rig, q, absx, absy,
// absz, the nine derivatives, the six state arrays, the six outputs.
// part: 0 fused (all six outputs), 1 the normal part (outputs 0-2), 2 the
// shear part (outputs 3-5).  Tiles (bx, by, bz) must be >= 1 and within
// the grid.  Returns the launch's cudaError_t (0 = success).
extern "C" int repro_fdm_stress(const void* const* ptrs, int part, int nx,
                                int ny, int nz, int bx, int by, int bz,
                                float dt, void* stream) {
  FdmArgs a;
  const float* const* in = reinterpret_cast<const float* const*>(ptrs);
  a.lam = in[0];
  a.rig = in[1];
  a.q = in[2];
  a.absx = in[3];
  a.absy = in[4];
  a.absz = in[5];
  for (int n = 0; n < 9; ++n) a.d[n] = in[6 + n];
  for (int n = 0; n < 6; ++n) a.s[n] = in[15 + n];
  for (int n = 0; n < 6; ++n) a.o[n] = const_cast<float*>(in[21 + n]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bx < 1 || by < 1 || bz < 1 || (long long)bx * by * bz > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  switch (part) {
    case kFused: return launch_fdm<kFused>(a, nx, ny, nz, bx, by, bz, dt, st);
    case kNormal: return launch_fdm<kNormal>(a, nx, ny, nz, bx, by, bz, dt, st);
    case kShear: return launch_fdm<kShear>(a, nx, ny, nz, bx, by, bz, dt, st);
    default: return cudaErrorInvalidValue;
  }
}
