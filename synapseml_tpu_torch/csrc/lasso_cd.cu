// Kernel L: the lasso's cyclic coordinate descent of the local explainers.
//
// Replaces: synapseml_tpu/explainers/regression.py::_fit_core's lasso
// branch (:72-85), vmapped over every (instance, target) fit by
// fit_regression_batch (:106-141): fori_loop over max_iter sweeps of a
// fori_loop over the k coordinates, each step
//   rho  = Xty[j] - gram[j] @ beta + gram[j, j] * beta[j]
//   b_j  = sign(rho) * max(|rho| - lam, 0)
//   b_j  = sq[j] > 0 ? b_j / sq[j] : 0
// on the rescaled system's Gram matrix, which the wrapper
// (explainers/regression.py) forms with one batched matmul beforehand, as
// the reference forms it with an XLA dot outside the loop. The fits of one
// instance share its Gram matrix and sq (the targets differ only in Xty).
//
// Bound on the H100: max_iter * k * 2k flops a fit at the f32 rate, against
// the Gram matrices read once. What holds it is the chain: step j + 1 reads
// beta[j], so a fit's k * max_iter steps run one after another, and the
// time is that chain's latency a step.
//
// Design (the second; the first gave each fit a block whose one busy warp
// summed gram[j] @ beta with a butterfly of shuffles every step):
// - covariance updates: each fit keeps c = Xty - G beta. Step j reads
//   rho = c_j + G_jj * beta_j (the reference's terms summed in another
//   order); with delta = b_j' - b_j, every c_i then takes c_i - G(i, j)
//   delta, except where delta is exactly 0. No step reduces anything;
// - one block an instance: its Gram matrix is staged once, as the packed
//   upper triangle (G symmetric: entry (min(i, j), max(i, j))), and each of
//   its t fits (up to kMaxWarps a block, more blocks past that) gets a warp.
//   Lane l owns coordinates l, l + 32, ...: their c and beta in the warp's
//   shared memory, the diagonal and sq in the block's;
// - a sweep takes the coordinates 32 at a time (a slot). The slot's 32
//   steps are one chain in registers: each lane holds its coordinate's c,
//   beta, diagonal, sq, and its row of the slot's 32 x 32 tile of G; every
//   lane runs the step on its own coordinate, one shuffle hands step m's
//   delta from lane m to the warp, and each lane updates its own c. The
//   slot's 32 deltas then update the other slots' c in one batch (each lane
//   its own coordinates, the deltas in step order: the same rounding as
//   updating at every step), skipped when no coefficient of the slot moved;
//   two slots at once, each chunk of steps' entries loaded before its
//   updates (8 steps from shared memory, all 32 from L2). Every load takes
//   its offset from a select, not a branch, so the warp never diverges;
// - the division: b_j' is soft / sq_j rounded once to f32, computed as the
//   product of soft with 1 / sq_j in double (one rounding each) then
//   rounded to f32. Within 2^-52 of soft / sq_j, it rounds as the f32
//   division does (a quotient of f32 values lies at least 2^-49 of itself
//   from a midpoint of f32 values), without the division's slow-path branch
//   on the chain;
// - a row of the Gram matrix with a NaN or an infinity makes that row's
//   rho NaN at every step, as the reference's dot does (0 * inf and NaN
//   propagate there): its diagonal is staged as NaN. A NaN beta then
//   reaches every c, as it reaches every dot. Where such a row exists the
//   updates select (delta != 0) instead of relying on c - G * 0 == c;
// - every product and sum is rounded on its own (__fmul_rn, __fadd_rn,
//   __fsub_rn: no fused multiply-add), so the order is exactly
//   tools/kernel_cases.py::lasso_cd_order's;
// - past the k whose triangle fits a block's shared memory (k <= 336 on the
//   H100's 227 KB, with one warp's c and beta beside it), the same kernel
//   reads the tile and the batches' rows of the full matrix (row j as it
//   lies, coalesced) from global memory (L2).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;   // fits a block, one warp each (256 threads: 255 registers)
constexpr int kThreadsMax = kMaxWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
// a batch updates kGroup slots at once and loads kChunk steps' entries
// before their updates: from shared memory a few, from L2 (past the
// triangle's reach) all 32, so that more loads are in flight
template <bool TRI> constexpr int kGroup = 2;
template <bool TRI> constexpr int kChunk = TRI ? 8 : 32;

// offset of row i of the packed upper triangle (row i holds G[i][i..k-1])
__host__ __device__ inline long long tri_base(int i, int k) {
  return (long long)i * k - (long long)i * (i - 1) / 2;
}

// the reference's step on rho = c + d * b: the soft threshold, then the
// division by s (rinv = 1 / s in double; 0 where s is not positive); NaN
// stays NaN
__device__ __forceinline__ float coord_step(float c, float d, float b, float s, double rinv,
                                            float lam) {
  const float rho = __fadd_rn(c, __fmul_rn(d, b));
  const float x = __fsub_rn(fabsf(rho), lam);
  const float mag = x <= 0.0f ? 0.0f : x;                    // NaN stays NaN
  const float soft = rho == 0.0f ? 0.0f : copysignf(mag, rho);  // sign(rho) * mag
  return s > 0.0f ? __double2float_rn(__dmul_rn((double)soft, rinv)) : 0.0f;
}

// c - g * delta, or c where delta is 0 (SAFE: the Gram matrix may hold a
// non-finite entry, where g * 0 is NaN)
template <bool SAFE>
__device__ __forceinline__ float update(float c, float g, float delta) {
  const float u = __fsub_rn(c, __fmul_rn(g, delta));
  if constexpr (SAFE) {
    return delta != 0.0f ? u : c;
  } else {
    return u;
  }
}

struct Fit {
  float* c;         // the warp's c (k), lane l's coordinates at l, l + 32, ...
  float* b;         // the warp's beta (k)
  const float* d;   // the diagonal (NaN for a row with a non-finite entry), k
  const float* s;   // sq, k
  const float* tri; // the packed upper triangle (TRI), else null
  const float* g;   // the instance's full matrix in global memory
  int k;
  float lam;
};

// G(a, j) for the slot's tile, 0 past k: the triangle's (min, max) entry, or
// row j of the full matrix as it lies. One load from a selected offset (a
// load on either side of a branch would diverge across the warp).
template <bool TRI>
__device__ __forceinline__ float tile_entry(const Fit& f, int a, int j) {
  const bool ok = a < f.k && j < f.k;
  const int lo = a < j ? a : j, hi = a < j ? j : a;
  const int off = TRI ? (int)tri_base(lo, f.k) - lo + hi : j * f.k + a;
  const float v = (TRI ? f.tri : f.g)[ok ? off : 0];
  return ok ? v : 0.0f;
}

// One sweep's slot r: the chain of its steps, then the batch. SAFE selects
// the updates (a non-finite entry somewhere in G); FULL_SLOT: all 32 of the
// slot's coordinates exist.
template <bool TRI, bool SAFE, bool FULL_SLOT>
__device__ __forceinline__ void slot(const Fit& f, int r, int nslots, float (&T)[32],
                                     bool load_tile) {
  const int lane = threadIdx.x & 31, j0 = 32 * r, a = j0 + lane, k = f.k;
  const int lmax = FULL_SLOT ? 32 : k - j0;
  const bool valid = a < k;
  float c = valid ? f.c[a] : 0.0f, b = valid ? f.b[a] : 0.0f;
  const float d = valid ? f.d[a] : 0.0f, s = valid ? f.s[a] : 0.0f;
  const double rinv = s > 0.0f ? 1.0 / (double)s : 0.0;
  const float lam = f.lam;
  if (load_tile) {
#pragma unroll
    for (int m = 0; m < 32; ++m) T[m] = tile_entry<TRI>(f, a, j0 + m);
  }
  float dm[32];
  bool moved = false;
#pragma unroll
  for (int m = 0; m < 32; ++m) {
    if (!FULL_SLOT && m >= lmax) {
      dm[m] = 0.0f;
      continue;
    }
    // every lane steps its own coordinate; lane m's is step j0 + m
    const float nb = coord_step(c, d, b, s, rinv, lam);
    const float delta = __shfl_sync(kFull, __fsub_rn(nb, b), m);
    if (lane == m) b = nb;
    c = update<SAFE>(c, T[m], delta);
    dm[m] = delta;
    moved |= delta != 0.0f;
  }
  if (valid) {
    f.c[a] = c;
    f.b[a] = b;
  }
  if (!moved || nslots == 1) return;
  // the batch: the other slots' c, each lane its own coordinates, the
  // deltas in step order; kGroup slots at a time (independent chains), the
  // entries of kChunk steps loaded before their updates
  for (int q0 = 0; q0 < nslots; q0 += kGroup<TRI>) {
    float cq[kGroup<TRI>];
    int base[kGroup<TRI>];  // entry (i, j0 + m) at base + m * stride (k^2 < 2^31)
    int stride[kGroup<TRI>];
    bool ok[kGroup<TRI>];
#pragma unroll
    for (int u = 0; u < kGroup<TRI>; ++u) {
      const int q = q0 + u, i = 32 * q + lane;
      ok[u] = q != r && q < nslots && i < k;
      const float cv = f.c[ok[u] ? i : 0];
      cq[u] = ok[u] ? cv : 0.0f;
      if (TRI && q < r) {        // row i of the triangle, columns j0 + m
        base[u] = (int)tri_base(i, k) - i + j0;
        stride[u] = 0;
      } else if (TRI) {          // row j0 + m of the triangle, column i
        base[u] = (int)tri_base(j0, k) - j0 + i;
        stride[u] = k - j0 - 1;
      } else {                   // row j0 + m of the full matrix, column i
        base[u] = j0 * k + i;
        stride[u] = k;
      }
    }
    const float* src = TRI ? f.tri : f.g;
#pragma unroll
    for (int m0 = 0; m0 < 32; m0 += kChunk<TRI>) {
      float gv[kChunk<TRI>][kGroup<TRI>];
#pragma unroll
      for (int m = m0; m < m0 + kChunk<TRI>; ++m)
#pragma unroll
        for (int u = 0; u < kGroup<TRI>; ++u) {
          // triangle rows past row j0 shrink by one a row: m (k - j0 - 1) - m (m - 1) / 2
          const int off = base[u] + (TRI && stride[u] == 0
                                         ? m : m * stride[u] - (TRI ? m * (m - 1) / 2 : 0));
          const bool live = ok[u] && (FULL_SLOT || m < lmax);
          const float v = src[live ? off : 0];
          gv[m - m0][u] = live ? v : 0.0f;
        }
#pragma unroll
      for (int m = m0; m < m0 + kChunk<TRI>; ++m)
#pragma unroll
        for (int u = 0; u < kGroup<TRI>; ++u) cq[u] = update<SAFE>(cq[u], gv[m - m0][u], dm[m]);
    }
#pragma unroll
    for (int u = 0; u < kGroup<TRI>; ++u)
      if (ok[u]) f.c[32 * (q0 + u) + lane] = cq[u];
  }
}

template <bool TRI, bool SAFE>
__device__ __forceinline__ void sweeps(const Fit& f, int max_iter) {
  const int nslots = (f.k + 31) / 32;
  const bool last_full = f.k % 32 == 0;
  float T[32];
  for (int it = 0; it < max_iter; ++it) {
    for (int r = 0; r < nslots; ++r) {
      const bool load = nslots > 1 || it == 0;  // one slot keeps its tile
      if (r + 1 < nslots || last_full) {
        slot<TRI, SAFE, true>(f, r, nslots, T, load);
      } else {
        slot<TRI, SAFE, false>(f, r, nslots, T, load);
      }
    }
  }
}

// Row i of g read whole by one warp: its diagonal, or NaN where the row
// holds a NaN or an infinity (*bad set). `keep` (or null) receives the
// row's upper part, keep[0] the diagonal.
__device__ __forceinline__ float stage_row(const float* g, int i, int k, float* keep, bool* bad) {
  const float* row = g + (long long)i * k;
  bool own = false;
  for (int j = threadIdx.x & 31; j < k; j += 32) {
    const float v = row[j];
    own |= !isfinite(v);
    if (keep != nullptr && j > i) keep[j - i] = v;
  }
  const bool any = __any_sync(kFull, own);
  *bad |= any;
  return any ? __int_as_float(0x7fffffff) : row[i];
}

// Shared memory: (TRI) the triangle, k (k + 1) / 2; the diagonal and sq,
// 2k; c and beta of each warp's fit, 2k a warp.
template <bool TRI>
__global__ void __launch_bounds__(kThreadsMax)
lasso_cd_kernel(const float* __restrict__ gram, const float* __restrict__ xty,
                const float* __restrict__ sq, float* __restrict__ beta, int t, int k,
                int max_iter, float lam) {
  extern __shared__ float smem[];
  const int W = blockDim.x >> 5, w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long inst = blockIdx.x;
  const long long tri_len = TRI ? (long long)k * (k + 1) / 2 : 0;
  float* s_tri = smem;
  float* s_d = smem + tri_len;
  float* s_s = s_d + k;
  float* s_c = s_s + k + 2LL * k * w;
  float* s_b = s_c + k;
  const float* g = gram + inst * (long long)k * k;
  bool bad = false;
  for (int i = w; i < k; i += W) {
    float* keep = TRI ? s_tri + tri_base(i, k) : nullptr;
    const float d = stage_row(g, i, k, keep, &bad);
    if (lane == 0) {
      s_d[i] = d;
      if (TRI) keep[0] = d;
    }
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) s_s[i] = sq[inst * k + i];
  const int target = blockIdx.y * W + w;
  const long long fit = inst * t + target;
  if (target < t) {
    for (int i = lane; i < k; i += 32) {
      s_c[i] = xty[fit * k + i];
      s_b[i] = 0.0f;
    }
  }
  const bool safe = __syncthreads_or(bad) != 0;
  if (target >= t) return;
  const Fit f{s_c, s_b, s_d, s_s, TRI ? s_tri : nullptr, g, k, lam};
  if (safe) {
    sweeps<TRI, true>(f, max_iter);
  } else {
    sweeps<TRI, false>(f, max_iter);
  }
  __syncwarp();
  for (int i = lane; i < k; i += 32) beta[fit * k + i] = s_b[i];
}

int optin_bytes(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

long long smem_bytes(bool tri, int k, int warps) {
  return 4LL * ((tri ? (long long)k * (k + 1) / 2 : 0) + 2LL * k + 2LL * k * warps);
}

// the largest k whose triangle fits `optin` bytes beside one warp's vectors
int tri_k(int optin) {
  int k = 0;
  while (smem_bytes(true, k + 1, 1) <= optin) ++k;
  return k;
}

template <bool TRI>
cudaError_t launch(long long n_inst, int t, int warps, cudaStream_t stream, const float* gram,
                   const float* xty, const float* sq, float* beta, int k, int max_iter,
                   float lam) {
  const size_t bytes = (size_t)smem_bytes(TRI, k, warps);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lasso_cd_kernel<TRI>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)n_inst, (unsigned)((t + warps - 1) / warps));
  lasso_cd_kernel<TRI><<<grid, 32 * warps, bytes, stream>>>(gram, xty, sq, beta, t, k, max_iter,
                                                            lam);
  return cudaGetLastError();
}

}  // namespace

// Largest k whose Gram matrix the kernel keeps in shared memory on the
// current device (as the packed upper triangle).
extern "C" int smt_lasso_smem_k(int* out) {
  int optin = 0;
  const int err = optin_bytes(&optin);
  if (err != 0) return err;
  *out = tri_k(optin);
  return 0;
}

// The launch's plan for k coordinates and t fits an instance on the current
// device: out[0] 1 where the Gram matrix sits in shared memory (the
// triangle), out[1] the fits a block (a warp each), 0 where none fit.
extern "C" int smt_lasso_plan(int k, int t, int* out) {
  int optin = 0;
  const int err = optin_bytes(&optin);
  if (err != 0) return err;
  const bool tri = k <= tri_k(optin);
  long long warps = (optin - smem_bytes(tri, k, 0)) / (8LL * k);
  if (warps > kMaxWarps) warps = kMaxWarps;
  if (warps > t) warps = t;
  out[0] = tri;
  out[1] = warps < 1 ? 0 : (int)warps;
  return 0;
}

// gram (n, k, k), sq (n, k): one per instance; xty, beta (n * t, k): one per
// fit, fit = instance * t + target. All f32, contiguous, on the device.
extern "C" int smt_lasso_cd(const void* gram, const void* xty, const void* sq, void* beta,
                            long long n_fits, int t, int k, int max_iter, float lam,
                            void* stream) {
  if (n_fits <= 0 || k <= 0) return 0;
  if (t <= 0 || max_iter < 0 || n_fits % t != 0 || n_fits > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int plan[2];
  const int err = smt_lasso_plan(k, t, plan);
  if (err != 0) return err;
  if (plan[1] < 1) return (int)cudaErrorInvalidValue;
  const float* G = static_cast<const float*>(gram);
  const float* X = static_cast<const float*>(xty);
  const float* Q = static_cast<const float*>(sq);
  float* out = static_cast<float*>(beta);
  cudaStream_t s = (cudaStream_t)stream;
  const long long n_inst = n_fits / t;
  return (int)(plan[0] ? launch<true>(n_inst, t, plan[1], s, G, X, Q, out, k, max_iter, lam)
                       : launch<false>(n_inst, t, plan[1], s, G, X, Q, out, k, max_iter, lam));
}

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
