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
// once per block (28 x 63 entries is 7 KB); a table too large for that is
// read through the cache instead. The (n, d) elements are one flat stream
// cut into groups of 4 consecutive elements (n*d need not be a multiple of
// 4: the last 0-3 elements take a scalar tail). Each thread takes two groups
// a pass, blockDim groups apart, with 16-byte loads (neighbouring threads on
// neighbouring 16 bytes), issues both loads before any search, then walks
// the eight binary searches together, step by step, so their shared-memory
// loads overlap; that keeps 32 bytes in flight a thread where one 4-byte
// load and its dependent search held the first version to 25-30 % of the
// bytes bound. A group's 4 bins leave in one store (int8: 32 bits; int16:
// 64; int32: 128). Each thread keeps its groups' feature index up to date
// by adding the pass's stride mod d, with no division per element. The
// search is branch-free: binary lifting over the power-of-two steps of Emax.
// What remains is the searches' shared-memory loads, whose addresses depend
// on the data, so a warp's lanes hit banks at random (PERF.md, Findings).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 2;  // groups of 4 elements a thread a pass

// 4 bins as one store of the output type
template <typename OutT> struct Packed;
template <> struct Packed<int8_t> {
  using T = uint32_t;
  __device__ static T make(const int* b) {
    return (uint32_t)(b[0] & 0xff) | (uint32_t)(b[1] & 0xff) << 8 |
           (uint32_t)(b[2] & 0xff) << 16 | (uint32_t)(b[3] & 0xff) << 24;
  }
};
template <> struct Packed<int16_t> {
  using T = uint2;
  __device__ static T make(const int* b) {
    return make_uint2((uint32_t)(b[0] & 0xffff) | (uint32_t)(b[1] & 0xffff) << 16,
                      (uint32_t)(b[2] & 0xffff) | (uint32_t)(b[3] & 0xffff) << 16);
  }
};
template <> struct Packed<int32_t> {
  using T = int4;
  __device__ static T make(const int* b) { return make_int4(b[0], b[1], b[2], b[3]); }
};

// j + e mod d, for j < d and e < 4
__device__ __forceinline__ int wrap(int j, int d) {
  if (j >= d) j -= d;
  if (j >= d) j %= d;  // only when d < 4
  return j;
}

// The bins of kN values v[e] of features j[e]: numeric, #(entries < v)
// clamped to len - 1; categorical, that count where the entry equals v, else
// the missing bin; non-finite v, the missing bin. The kN searches advance
// together, one lifting step at a time.
template <int kN>
__device__ __forceinline__ void bin_values(const float* v, const int* j, const float* tab,
                                           const int* len, const int8_t* cat, int emax,
                                           int missing, int top_step, int* out) {
  int pos[kN];
#pragma unroll
  for (int e = 0; e < kN; ++e) pos[e] = 0;
  for (int step = top_step; step > 0; step >>= 1) {
#pragma unroll
    for (int e = 0; e < kN; ++e) {
      const int q = pos[e] + step;  // the row is sorted, padded with +inf
      if (q <= emax && tab[(size_t)j[e] * emax + q - 1] < v[e]) pos[e] = q;
    }
  }
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    const int lj = len[j[e]];
    int b;
    if (cat[j[e]]) {
      b = (pos[e] < lj && tab[(size_t)j[e] * emax + pos[e]] == v[e]) ? pos[e] : missing;
    } else {
      b = pos[e] < lj - 1 ? pos[e] : lj - 1;
    }
    out[e] = isfinite(v[e]) ? b : missing;
  }
}

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
  using P = Packed<OutT>;
  const long long total = n * d;
  const long long groups = total >> 2;
  const long long per_pass = (long long)kGroups * blockDim.x;  // groups a block a pass
  // the first group of this thread, and the feature of its first element
  long long g = (long long)blockIdx.x * per_pass + threadIdx.x;
  int j0 = (int)((4 * g) % d);
  const int j_lane = (int)((4LL * blockDim.x) % d);                 // group k -> k+1
  const int j_pass = (int)((4 * per_pass * gridDim.x) % d);          // pass -> pass
  const float4* x4 = reinterpret_cast<const float4*>(x);
  typename P::T* o4 = reinterpret_cast<typename P::T*>(out);
  for (; g < groups; g += per_pass * gridDim.x) {
    float v[4 * kGroups];
    int j[4 * kGroups];
    int jg = j0;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const long long gk = g + (long long)k * blockDim.x;
      const float4 f = gk < groups ? __ldcs(x4 + gk) : make_float4(0.f, 0.f, 0.f, 0.f);
      v[4 * k] = f.x;
      v[4 * k + 1] = f.y;
      v[4 * k + 2] = f.z;
      v[4 * k + 3] = f.w;
#pragma unroll
      for (int e = 0; e < 4; ++e) j[4 * k + e] = wrap(jg + e, d);
      jg = wrap(jg + j_lane, d);
    }
    int b[4 * kGroups];
    bin_values<4 * kGroups>(v, j, tab, len, cat, emax, missing, top_step, b);
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const long long gk = g + (long long)k * blockDim.x;
      if (gk < groups) __stcs(o4 + gk, P::make(b + 4 * k));
    }
    j0 = wrap(j0 + j_pass, d);
  }
  // the last total mod 4 elements, one a thread of block 0
  const long long tail = 4 * groups + threadIdx.x;
  if (blockIdx.x == 0 && tail < total) {
    const float v = x[tail];
    const int j = (int)(tail % d);
    int b;
    bin_values<1>(&v, &j, tab, len, cat, emax, missing, top_step, &b);
    out[tail] = (OutT)b;
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
  const long long per_pass = (long long)kGroups * kThreads;
  const long long passes = ((n * d >> 2) + per_pass - 1) / per_pass;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > passes) grid = passes;
  if (grid < 1) grid = 1;  // fewer than 4 elements: block 0 takes the tail
  kern<<<(unsigned)grid, kThreads, smem, s>>>(x, table, lens, cat, emax, (OutT*)out, n, d,
                                              missing, top_step);
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
  // 16-byte loads of x; one store of 4 bins (the output is a fresh tensor)
  if (emax < 1 || (uintptr_t)x % 16 != 0 || (uintptr_t)out % (4 * out_bytes) != 0)
    return (int)cudaErrorInvalidValue;
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
