// Kernel D: raw feature rows to histogram bins, on the device.
//
// Replaces: synapseml_tpu/gbdt/device_predict.py::device_bin_cat
// (device_predict.py:208, its XLA program _device_bin_cat_kernel at :246),
// which the reference runs whenever device binning is exact
// (boost.py:1718-1723). It takes (n, d) f32 rows and the (d, Emax) f32 table
// of pack_feature_table (numeric rows: the f64 edges rounded down to f32;
// categorical rows: the sorted category values; padding +inf), the (d,)
// lengths and the (d,) categorical flags, and writes (n, d) bins:
//   numeric feature:     #(entries < v), clamped to len - 1;
//   categorical feature: the position of the entry equal to v, or the missing
//                        bin when no entry equals v (an unseen category);
//   v not finite:        the missing bin.
// The reference computes this as an (n, d, Emax) broadcast compare; here each
// (row, feature) element takes a binary search of its feature's row of the
// table, which is sorted (rounding down keeps the edges in order), so the
// position it finds is the same count. Comparisons are IEEE (-0.0 == +0.0,
// as in the reference); the file must be built without --use_fast_math.
//
// Bound on the H100: bytes. Each f32 input is read once and each bin written
// once at its stored width (int8/int16/int32: no int32 intermediate, no cast
// pass): n*d*(4 + out bytes). The search is log2(Emax) shared-memory loads.
//
// Design: the table, the lengths and the flags are staged in shared memory
// once per block (28 x 256 entries is 28 KB); a table too large for that is
// read through the cache instead. Blocks walk tiles of kRowsPerTile rows; a
// thread takes the elements t, t + blockDim, ... of its tile's row-major
// (rows x d) slice, so neighbouring threads read neighbouring floats
// (coalesced) and write neighbouring bins. Each thread keeps its element's
// feature index up to date by adding blockDim mod d, with no division per
// element. The search is branch-free: binary lifting over the power-of-two
// steps of Emax.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerTile = 64;

template <typename OutT, bool kShared>
__global__ void __launch_bounds__(kThreads)
bin_features_kernel(const float* __restrict__ x, const float* __restrict__ table,
                    const int* __restrict__ lens, const int8_t* __restrict__ cat_flags,
                    int emax, OutT* __restrict__ out, long long n, int d, int missing,
                    int top_step) {
  extern __shared__ float smem[];
  const float* tab = table;
  const int* len = lens;
  const int8_t* cat = cat_flags;
  if (kShared) {
    float* s_tab = smem;
    int* s_len = reinterpret_cast<int*>(s_tab + (size_t)d * emax);
    int8_t* s_cat = reinterpret_cast<int8_t*>(s_len + d);
    for (int i = threadIdx.x; i < d * emax; i += blockDim.x) s_tab[i] = table[i];
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      s_len[i] = lens[i];
      s_cat[i] = cat_flags[i];
    }
    __syncthreads();
    tab = s_tab;
    len = s_len;
    cat = s_cat;
  }
  const long long n_tiles = (n + kRowsPerTile - 1) / kRowsPerTile;
  const int j_step = blockDim.x % d;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * kRowsPerTile;
    const long long rows = n - row0 < kRowsPerTile ? n - row0 : kRowsPerTile;
    const int count = (int)rows * d;
    const float* xt = x + row0 * d;
    OutT* ot = out + row0 * d;
    int j = threadIdx.x % d;
    for (int k = threadIdx.x; k < count; k += blockDim.x) {
      const float v = xt[k];
      int b = missing;
      if (isfinite(v)) {
        const float* r = tab + (size_t)j * emax;
        int pos = 0;  // #(entries < v): the row is sorted, padded with +inf
        for (int step = top_step; step > 0; step >>= 1) {
          if (pos + step <= emax && r[pos + step - 1] < v) pos += step;
        }
        const int lj = len[j];
        if (cat[j]) {
          b = (pos < lj && r[pos] == v) ? pos : missing;
        } else {
          b = pos < lj - 1 ? pos : lj - 1;
        }
      }
      ot[k] = (OutT)b;
      j += j_step;
      if (j >= d) j -= d;
    }
  }
}

template <typename OutT, bool kShared>
cudaError_t launch_one(const float* x, const float* table, const int* lens,
                       const int8_t* cat, int emax, void* out, long long n, int d,
                       int missing, int top_step, size_t smem, cudaStream_t s) {
  auto kern = bin_features_kernel<OutT, kShared>;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                           smem)) != cudaSuccess)
    return err;
  const long long n_tiles = (n + kRowsPerTile - 1) / kRowsPerTile;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > n_tiles) grid = n_tiles;
  bin_features_kernel<OutT, kShared><<<(unsigned)grid, kThreads, smem, s>>>(
      x, table, lens, cat, emax, (OutT*)out, n, d, missing, top_step);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch(const float* x, const float* table, const int* lens, const int8_t* cat,
                   int emax, void* out, long long n, int d, int missing, cudaStream_t s) {
  int top_step = 1;
  while (top_step * 2 <= emax) top_step *= 2;
  const size_t smem = (size_t)d * emax * sizeof(float) + (size_t)d * sizeof(int) + d;
  if (smem <= 200 * 1024) {
    return launch_one<OutT, true>(x, table, lens, cat, emax, out, n, d, missing, top_step,
                                  smem, s);
  }
  return launch_one<OutT, false>(x, table, lens, cat, emax, out, n, d, missing, top_step,
                                 0, s);
}

}  // namespace

extern "C" int smt_bin_features(const void* x, const void* table, const void* lens,
                                const void* cat_flags, int emax, void* out, long long n,
                                int d, int out_bytes, int missing, void* stream) {
  const float* xf = (const float*)x;
  const float* tf = (const float*)table;
  const int* lf = (const int*)lens;
  const int8_t* cf = (const int8_t*)cat_flags;
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || d <= 0) return 0;
  // a tile's element count is a 32-bit int
  if (emax < 1 || (long long)kRowsPerTile * d > (1LL << 30)) return (int)cudaErrorInvalidValue;
  switch (out_bytes) {
    case 1: return (int)launch<int8_t>(xf, tf, lf, cf, emax, out, n, d, missing, s);
    case 2: return (int)launch<int16_t>(xf, tf, lf, cf, emax, out, n, d, missing, s);
    case 4: return (int)launch<int32_t>(xf, tf, lf, cf, emax, out, n, d, missing, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
