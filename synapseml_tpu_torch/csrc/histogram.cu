// Kernel A: gradient histogram for the GBDT grower.
//
// Replaces: synapseml_tpu/gbdt/histogram.py::_hist_scatter / _hist_onehot
// (histogram.py:27-86), reached through histogram_panel (histogram.py:89).
// For every (feature f, bin b) it sums [g*w, h*w, w] over the rows whose bin
// in feature f is b, giving a (d, B, 3) f32 histogram. The products are taken
// here, from the (n,) g, h and w vectors, so no (n, 3) panel is built first.
//
// Rows that cannot change the result are skipped: a row contributes iff
// w != 0 || !isfinite(g) || !isfinite(h). A row of weight 0 with finite g
// and h adds (+-0, +-0, 0), and +-0 never changes a cell that starts at +0;
// a non-finite g or h makes g*0 or h*0 NaN, so that row is still added. A
// split step weights the rows by a 0/1 mask of the new child, so most of its
// rows are skipped.
//
// Bound on the H100: bytes. g, h and w are read for every row (12n bytes);
// the bins only for the n_live contributing rows (n_live*d*sizeof(bin)); the
// output is d*B*12 bytes. The arithmetic (2 multiplies and 3 adds per
// element) is negligible; what the design has to keep cheap is the
// shared-memory atomics (3 per live element) and the latency of the bin
// loads.
//
// Design: a warp takes 32 consecutive rows at a time. Its lanes load w, g
// and h for those rows (coalesced, one group ahead), form g*w and h*w once
// per row with __fmul_rn (no contraction, as PyTorch rounds), and take a
// __ballot_sync of the contributing rows. The warp then walks only those,
// four at a time: the row's three values are broadcast with __shfl_sync,
// lane j reads the row's bin of feature j (looping when d > 32; one
// coalesced segment per row at the stored width, four rows' loads in flight
// together) and adds the three values to its feature's cell with
// shared-memory atomics. Each feature's (B, 3) slice of the block's
// sub-histogram starts at f*(3B + 1) floats: the odd stride puts the same
// bin of 32 features in 32 different banks, where a stride of 3B (a multiple
// of 32 at B = 64) put them all in one. Blocks cover a tile of features (all
// d when d*(3B + 1)*4 bytes fit; grid y walks feature tiles otherwise, e.g.
// int32 bins with 4096 bins). At the end each block merges its non-zero
// cells into the global histogram with global atomics; the grid is sized by
// the occupancy calculator, so the merge costs O(SMs), not O(n). No 64-bit
// division per element.
//
// On sm_90a a float atomicAdd to shared memory is a compare-and-swap loop
// (ATOMS.CAST.SPIN in the SASS), so the atomics, not the bytes, set the pace
// when most rows contribute; the kernel stays under 64 registers a thread
// so that at least four blocks (32 warps) per SM hide their latency.
// Per-warp private copies with
// plain adds (no atomics) were faster when most rows contribute but slower
// on the sparse weightings of split steps, which are 300 of a fit's 310
// launches, and were not kept (PERF.md, Findings).
//
// The row-list entry (smt_histogram_rows) is the same kernel over the rows
// ids[buffer][begin .. begin + count), with (begin, count, buffer) read from
// the card (kernel P's smaller child; ids is P's pair of id buffers, `stride`
// ids apart). It replaces leaf_hist_local's gather into a power-of-two
// buffer (synapseml_tpu/gbdt/grow.py:223-250): a lane reads its row id from
// the list (coalesced), then that row's g, h and w (gathered: a 32-byte
// sector each), and the row id is broadcast with the values, so each live
// row's bin segment is read from its own row. Its work is sized on the card:
// the grid is the occupancy's (the count is not known on the host), and
// each block first reads the span. A list of at most kDirectRows rows skips
// shared memory (list_direct: a warp a row, atomics straight into the
// output), since there a warp's walk of 32 live rows, 4 at a time, sets the
// time, not the rows' bytes. A longer list takes the sub-histograms with
// the blocks it needs, active = min(grid, ceil(count / kRowsPerBlock)),
// kRowsPerBlock being the rows a block takes before its zeroing and its
// merge pay for themselves (both from PERF.md's R table). A block past it
// returns before it zeroes its shared memory; the active blocks stride the
// list by `active`. With feature tiles (grid y) each rule holds in each
// tile. Bound: per listed row 4 bytes of id, 3 gathered sectors of g, h, w,
// and its bins; the output once.
//
// The sibling epilogue (smt_sibling) ends a growth step in one launch:
// with the split leaf l from kernel E's choice and smaller_right from kernel
// P, both read on the card, child = smaller_right ? small : hists[l] - small,
// hists[s + 1] = child, hists[l] = hists[l] - child, and small = 0 for the
// next step's row list (small is the grower's persistent buffer, which the
// row-list entry adds into). It replaces synapseml_tpu/gbdt/grow.py:408-414
// (jnp.where(ok, hists.at[s + 1].set(child).at[l].add(-child), hists)):
// x + (-c) and x - c are one IEEE result (__fsub_rn, no contraction), and an
// inert step (small = 0, smaller_right) leaves every leaf as it was (x - +0
// == x, -0.0 and NaN included). Bound: bytes, small and hists[l] read, two
// leaves and small written.
//
// Sums are taken in an order that changes from run to run. On gradients that
// were pre-rounded to a summation-exact grid (boost._preround), with 0/1
// weights, every partial sum is exact, and the result is bit-equal to any
// other order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "occupancy.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;                // live rows whose bins are loaded together
constexpr int kSmemBudget = 200 * 1024;  // bytes of one block's sub-histogram
constexpr unsigned kAll = 0xffffffffu;
// the row-list entry (PERF.md, the R table): a list of at most kDirectRows
// rows goes straight into the output; a longer one takes a block a
// kRowsPerBlock listed rows, up to the occupancy's grid
constexpr int kDirectRows = 8192;
constexpr int kRowsPerBlock = 256;

// The row-list entry over a short list: a warp a listed row at a time, a
// lane a feature (bins read as one segment of the row), each live element's
// three values added straight into the global histogram with atomics. No
// shared memory is zeroed or merged, and a warp's chain is one row's loads,
// not 32 rows walked 4 at a time: for a list of a few thousand rows this is
// the shorter path (PERF.md, the R table). A block whose first row lies past
// the list returns at once. Not inlined: inlined, it slowed the shared-memory
// path of long lists by 6 % on the H100 (PERF.md).
template <typename BinT>
__device__ __noinline__ void list_direct(const BinT* __restrict__ bins, const float* __restrict__ grad,
                            const float* __restrict__ hess,
                            const float* __restrict__ weight, float* __restrict__ out,
                            const int* __restrict__ ids, int count, int d, int n_bins,
                            int f0, int dt) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * kWarps;
  for (int r = blockIdx.x * kWarps + threadIdx.x / 32; r < count; r += warps) {
    const long long row = __ldg(ids + r);
    const float g = __ldg(grad + row), h = __ldg(hess + row), w = __ldg(weight + row);
    if (!(w != 0.f || !isfinite(g) || !isfinite(h))) continue;  // the same in every lane
    const float gw = __fmul_rn(g, w), hw = __fmul_rn(h, w);
    const BinT* at = bins + row * d + f0;
    for (int f = lane; f < dt; f += 32) {
      const int b = (int)at[f];
      if (b < 0 || b >= n_bins) continue;  // out-of-range bins are dropped
      float* cell = out + ((long long)(f0 + f) * n_bins + b) * 3;
      atomicAdd(cell, gw);
      atomicAdd(cell + 1, hw);
      atomicAdd(cell + 2, w);
    }
  }
}

template <typename BinT, bool kList>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const BinT* __restrict__ bins, const float* __restrict__ grad,
            const float* __restrict__ hess, const float* __restrict__ weight,
            float* __restrict__ out, long long n, int d, int n_bins, int tile,
            const int* __restrict__ order, long long stride, const int* __restrict__ span) {
  extern __shared__ float sh[];
  const int f0 = blockIdx.y * tile;
  const int dt = min(tile, d - f0);
  // the row-list entry walks positions of ids[buffer][begin, begin + count)
  // with the blocks its count needs; the full entry walks rows 0..n-1
  // (position r is row r) with the whole grid
  const int* ids = nullptr;
  long long active = gridDim.x;
  if constexpr (kList) {
    n = __ldg(span + 1);
    ids = order + __ldg(span + 2) * stride + __ldg(span);
    if (n <= kDirectRows) {  // a short list: straight into `out`
      list_direct(bins, grad, hess, weight, out, ids, (int)n, d, n_bins, f0, dt);
      return;
    }
    active = min(active, (n + kRowsPerBlock - 1) / kRowsPerBlock);
    if ((long long)blockIdx.x >= active) return;  // before zeroing shared memory
  }
  const int fstride = 3 * n_bins + 1;  // odd: one bank per feature for a bin
  for (int i = threadIdx.x; i < dt * fstride; i += blockDim.x) sh[i] = 0.f;
  __syncthreads();

  auto row_at = [&](long long r) -> long long {
    if constexpr (kList) return (long long)__ldg(ids + r);
    return r;
  };

  const int lane = threadIdx.x & 31;
  const long long n_groups = (n + 31) / 32;
  const long long step = active * kWarps;
  long long grp = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  // g, h and w of the warp's next group are loaded one group ahead
  float ng = 0.f, nh = 0.f, nw = 0.f;
  long long nrow = 0;
  if (grp < n_groups && grp * 32 + lane < n) {
    nrow = row_at(grp * 32 + lane);
    ng = __ldg(grad + nrow);
    nh = __ldg(hess + nrow);
    nw = __ldg(weight + nrow);
  }
  bool touched = false;
  for (; grp < n_groups; grp += step) {
    const float g = ng, h = nh, w = nw;
    const long long row = nrow;
    const long long r = grp * 32 + lane, r_next = r + step * 32;
    if (r_next < n) {
      nrow = row_at(r_next);
      ng = __ldg(grad + nrow);
      nh = __ldg(hess + nrow);
      nw = __ldg(weight + nrow);
    }
    const float gw = __fmul_rn(g, w), hw = __fmul_rn(h, w);
    const bool live = r < n && (w != 0.f || !isfinite(g) || !isfinite(h));
    unsigned mask = __ballot_sync(kAll, live);
    touched |= mask != 0;
    const BinT* rows = bins + grp * 32 * d + f0;  // the full entry's group
    while (mask) {
      int src[kBatch];
      const BinT* at[kBatch];
      float vg[kBatch], vh[kBatch], vw[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        src[u] = mask ? __ffs(mask) - 1 : -1;
        mask &= mask - 1;
        const int s = src[u] < 0 ? 0 : src[u];
        vg[u] = __shfl_sync(kAll, gw, s);
        vh[u] = __shfl_sync(kAll, hw, s);
        vw[u] = __shfl_sync(kAll, w, s);
        if constexpr (kList)
          at[u] = bins + __shfl_sync(kAll, (int)row, s) * (long long)d + f0;
      }
      for (int f = lane; f - lane < dt; f += 32) {
        int b[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const bool ld = src[u] >= 0 && f < dt;
          if constexpr (kList)
            b[u] = ld ? (int)at[u][f] : -1;
          else
            b[u] = ld ? (int)rows[(long long)src[u] * d + f] : -1;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (b[u] < 0 || b[u] >= n_bins) continue;  // out-of-range bins are dropped
          float* cell = sh + f * fstride + b[u] * 3;
          atomicAdd(cell, vg[u]);
          atomicAdd(cell + 1, vh[u]);
          atomicAdd(cell + 2, vw[u]);
        }
      }
    }
  }
  // a block that added no row has nothing to merge (every row it walked had
  // weight 0)
  if (!__syncthreads_or(touched)) return;

  float* o = out + (long long)f0 * n_bins * 3;
  const int cells = dt * n_bins * 3;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const float v = sh[i + i / (3 * n_bins)];  // cell i of feature f sits f floats later
    if (v != 0.f) atomicAdd(o + i, v);
  }
}

template <typename BinT, bool kList>
cudaError_t launch(const void* bins, const float* grad, const float* hess,
                   const float* weight, float* out, long long n, int d, int n_bins,
                   const int* order, long long stride, const int* span, cudaStream_t stream) {
  const int feat_bytes = (3 * n_bins + 1) * (int)sizeof(float);
  const int tile = min(d, max(1, kSmemBudget / feat_bytes));
  const int n_tiles = (d + tile - 1) / tile;
  const int smem = tile * feat_bytes;
  auto kern = hist_kernel<BinT, kList>;
  LaunchFacts lf;
  cudaError_t err = launch_facts((const void*)kern, kThreads, smem, &lf);
  if (err != cudaSuccess) return err;
  // the row-list entry's length is on the card: its grid is the occupancy's,
  // and its blocks size the work themselves
  const long long work = ((n + 31) / 32 + kWarps - 1) / kWarps;  // blocks of 8 row groups
  long long gx = (long long)lf.per_sm * lf.sms / n_tiles;
  if (gx < 1) gx = 1;
  if (!kList && gx > work) gx = work;
  dim3 grid((unsigned)gx, (unsigned)n_tiles);
  kern<<<grid, kThreads, smem, stream>>>((const BinT*)bins, grad, hess, weight, out, n,
                                         d, n_bins, tile, order, stride, span);
  return cudaGetLastError();
}

template <bool kList>
int dispatch(const void* bins, int bin_bytes, const void* grad, const void* hess,
             const void* weight, void* out, long long n, int d, int n_bins,
             const int* order, long long stride, const int* span, void* stream) {
  const float* g = (const float*)grad;
  const float* h = (const float*)hess;
  const float* w = (const float*)weight;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bin_bytes) {
    case 1:
      return (int)launch<int8_t, kList>(bins, g, h, w, o, n, d, n_bins, order, stride, span,
                                        s);
    case 2:
      return (int)launch<int16_t, kList>(bins, g, h, w, o, n, d, n_bins, order, stride, span,
                                         s);
    case 4:
      return (int)launch<int32_t, kList>(bins, g, h, w, o, n, d, n_bins, order, stride, span,
                                         s);
    default: return (int)cudaErrorInvalidValue;
  }
}

constexpr int kSiblingBlocks = 1024;  // grid cap of the epilogue (grid-stride beyond)

__global__ void __launch_bounds__(kThreads)
sibling_kernel(float* __restrict__ hists, float* __restrict__ small,
               const long long* __restrict__ choice, const int8_t* __restrict__ smaller_right,
               int s, long long cells) {
  float* parent = hists + choice[0] * cells;  // leaf l <= s: never leaf s + 1
  float* sib = hists + (long long)(s + 1) * cells;
  const bool right = smaller_right[0] != 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < cells;
       i += (long long)gridDim.x * blockDim.x) {
    const float x = parent[i], m = small[i];
    const float c = right ? m : __fsub_rn(x, m);
    sib[i] = c;
    parent[i] = __fsub_rn(x, c);
    small[i] = 0.f;
  }
}

}  // namespace

extern "C" int smt_histogram(const void* bins, int bin_bytes, const void* grad,
                             const void* hess, const void* weight, void* out,
                             long long n, int d, int n_bins, void* stream) {
  return dispatch<false>(bins, bin_bytes, grad, hess, weight, out, n, d, n_bins, nullptr, 0,
                         nullptr, stream);
}

// Adds into `out` the histogram of the rows ids[span[2]][span[0] .. span[0] +
// span[1]) (buffer span[2] starting `stride` ids after buffer 0), span read on
// the card (kernel P's record of the smaller child): a list of at most
// kDirectRows rows straight into `out`, a longer one through shared-memory
// sub-histograms, a block a kRowsPerBlock rows.
extern "C" int smt_histogram_rows(const void* bins, int bin_bytes, const void* grad,
                                  const void* hess, const void* weight, void* out,
                                  const int* ids, long long stride, const int* span, int d,
                                  int n_bins, void* stream) {
  return dispatch<true>(bins, bin_bytes, grad, hess, weight, out, 0, d, n_bins, ids, stride,
                        span, stream);
}

// The step's sibling by subtraction over (L, cells) histograms: leaf
// choice[0] and leaf s + 1 from the (cells,) smaller child `small`, which is
// then zeroed.
extern "C" int smt_sibling(void* hists, void* small, const void* choice,
                           const void* smaller_right, int s, long long cells, void* stream) {
  if (cells < 1) return (int)cudaSuccess;
  const long long blocks = (cells + kThreads - 1) / kThreads;
  sibling_kernel<<<(unsigned)(blocks < kSiblingBlocks ? blocks : kSiblingBlocks), kThreads, 0,
                   (cudaStream_t)stream>>>((float*)hists, (float*)small,
                                           (const long long*)choice,
                                           (const int8_t*)smaller_right, s, cells);
  return (int)cudaGetLastError();
}

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
