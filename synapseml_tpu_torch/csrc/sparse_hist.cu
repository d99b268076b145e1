// Kernel G: the sparse (CSR) histogram of a GBDT growth step.
//
// Replaces: synapseml_tpu/gbdt/sparse.py::_cell_sum_fn (:312) with the rest
// of sparse_histogram_split (:377) and sparse_histogram_side (:415): the
// gather of the [g*w, h*w, w] panel at every stored entry's row, split by
// the row's side of the split, the sums of each (feature, bin) cell, the
// side totals, and each feature's zero-bin residual (total minus the
// feature's stored cells: the rows that hold no entry of the feature). The
// reference builds the sums scatter-free for the TPU, a chunked cumsum with
// a mean-centred inter-chunk prefix differenced at the cell ends, because
// TPU scatters are slow and long f32 prefixes cancel. Neither holds here:
// on gradients pre-rounded by boost._preround every partial sum is exact,
// so the sums may be taken in any order, with atomics.
//
// Inputs: the entries sorted by cell = feature * B + bin (rows, cells), the
// (n, 4) panel [g*w, h*w, w, 0], side (n,) (0 left, 1 right, >= 2 not a
// member of the split leaf), zero_bin (d,), and ctrl (half, slot, forced),
// read on the card. Output: out (2, d, B, 3) f32, totals (2, 3).
//   half = 0: both sides' histograms (6 channels a cell);
//   half = 1: only the smaller side's (3 channels), the side `forced` if it
//     is >= 0, else the right side iff its member count is not above the
//     left's (the reference's rule, grow.py:662); with `parent` given, the
//     other slot gets parent[slot] - small (the sibling by subtraction,
//     grow.py:689-695).
//
// Two launches a call:
//   1. the rows pass: each side's panel sum and member count, a register
//      sum a thread over a grid-stride of rows, block sums added into
//      `rowsum` with atomics; the last block to take a ticket (CUDA's
//      threadFenceReduction pattern) writes totals and the smaller side into
//      `state` and zeroes rowsum and its ticket for the next call.
//   2. the entries pass: one block a work item of the host's plan
//      (sparse.py::g_plan, made once a SparseBinned: the entry set is fixed
//      for a fit). A light item is a run of whole features holding at most
//      G_ENTRIES entries; its block sums them into shared memory (features x
//      B x channels f32), adds each feature's residual and writes every
//      cell of its features, empty ones included, with plain stores: no
//      cell is zeroed by another launch and none is written twice. A feature
//      with more entries is heavy: a block per G_ENTRIES of them adds its
//      sums into the feature's slot of `acc` with global atomics and takes
//      the slot's ticket; the last to arrive reads the slot, zeroes it and
//      its ticket, and writes the feature. In a block, a warp reads 32
//      consecutive entries at a time (coalesced rows and cells), gathers
//      each row's side and, for a member, its 16-byte panel, and reduces
//      runs of equal cells across the warp (a segmented shuffle scan, the
//      entries being sorted by cell): a cell gets one shared-memory atomic a
//      run, so a stop-word's cell that holds millions of entries costs one
//      atomic per 32 of them.
// Output cells are written once each, so no separate zeroing runs; a call
// leaves acc, rowsum and the tickets zero again.
//
// Bound on the H100: bytes. A call reads each entry's row and cell once (8
// bytes), the rows' side and the members' panel (counted in distinct
// 32-byte sectors: at 2^20 rows both fit the 50 MB L2), and writes the
// (2, d, B, 3) output (with `parent`, reads one slot of it too).

#include <cuda_runtime.h>
#include <stdint.h>

#include "occupancy.cuh"

// Field for field the _GArgs of gbdt/sparse.py. Outside the unnamed
// namespace: smt_sparse_hist takes it.
struct GArgs {
  const int* rows;        // (nnz,) row of each entry, entries sorted by cell
  const int* cells;       // (nnz,) feature * B + bin
  const int* side;        // (n,)
  const float4* panel;    // (n,) [g*w, h*w, w, 0]
  const int* zero_bin;    // (d,)
  const int* items;       // (n_items, 6): f0, f1, e0, e1, heavy slot or -1, blocks of the slot
  float* acc;             // (heavy, B, 6) heavy features' sums, zero between calls
  int* tickets;           // (heavy + 1,) the rows pass's, then each heavy slot's
  float* rowsum;          // (8,) the sides' 6 sums, then 2 member counts (int bits)
  int* state;             // (1,) the smaller side
  const int* ctrl;        // (3,) half, slot, forced
  float* out;             // (2, d, B, 3)
  float* totals;          // (2, 3)
  const float* parent;    // (2, d, B, 3) or null
  int n, d, B, n_items, max_feats, device;
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

// Takes a ticket of `counter`; true in the last of `blocks` blocks, which
// then sees every other block's writes.
__device__ bool last_block(int* counter, int blocks, bool* s_last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *s_last = atomicAdd(counter, 1) == blocks - 1;
  __syncthreads();
  if (!*s_last) return false;
  __threadfence();
  return true;
}

__global__ void __launch_bounds__(kThreads) sparse_rows_kernel(const GArgs a) {
  __shared__ float s_sum[kThreads / 32][8];
  __shared__ bool s_last;
  float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int c0 = 0, c1 = 0;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < a.n; r += gridDim.x * blockDim.x) {
    const int sd = a.side[r];
    if (sd == 0) {
      const float4 p = a.panel[r];
      v[0] = __fadd_rn(v[0], p.x);
      v[1] = __fadd_rn(v[1], p.y);
      v[2] = __fadd_rn(v[2], p.z);
      ++c0;
    } else if (sd == 1) {
      const float4 p = a.panel[r];
      v[3] = __fadd_rn(v[3], p.x);
      v[4] = __fadd_rn(v[4], p.y);
      v[5] = __fadd_rn(v[5], p.z);
      ++c1;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < 6; ++k) v[k] = __fadd_rn(v[k], __shfl_down_sync(kFull, v[k], o));
    c0 += __shfl_down_sync(kFull, c0, o);
    c1 += __shfl_down_sync(kFull, c1, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) s_sum[warp][k] = v[k];
    s_sum[warp][6] = __int_as_float(c0);
    s_sum[warp][7] = __int_as_float(c1);
  }
  __syncthreads();
  if (threadIdx.x < 8) {
    const int k = threadIdx.x;
    if (k < 6) {
      float t = 0.f;
      for (int w = 0; w < kThreads / 32; ++w) t = __fadd_rn(t, s_sum[w][k]);
      if (t != 0.f) atomicAdd(a.rowsum + k, t);
    } else {
      int t = 0;
      for (int w = 0; w < kThreads / 32; ++w) t += __float_as_int(s_sum[w][k]);
      if (t) atomicAdd(reinterpret_cast<int*>(a.rowsum) + k, t);
    }
  }
  if (!last_block(a.tickets, gridDim.x, &s_last)) return;
  if (threadIdx.x == 0) {
    volatile float* rs = a.rowsum;
    for (int k = 0; k < 6; ++k) {
      a.totals[k] = rs[k];
      rs[k] = 0.f;
    }
    volatile int* cnt = reinterpret_cast<volatile int*>(a.rowsum) + 6;
    const int n_left = cnt[0], n_right = cnt[1];
    cnt[0] = 0;
    cnt[1] = 0;
    const int forced = a.ctrl[2];
    a.state[0] = forced >= 0 ? forced : (n_right <= n_left ? 1 : 0);
    a.tickets[0] = 0;
  }
}

// The block's entries [e0, e1) into acc (cells of features f0.., C channels
// a cell): C = 6, both sides; C = 3, side `small` only.
template <int C>
__device__ void sum_entries(const GArgs& a, float* acc, int e0, int e1, int base_cell,
                            int small) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = e0 + warp * 32; j < e1; j += kThreads) {
    const int e = j + lane;
    int key = -1;
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) v[c] = 0.f;
    if (e < e1) {
      key = a.cells[e] - base_cell;
      const int r = a.rows[e];
      const int sd = a.side[r];
      // constant register indices: a computed one would put v in local memory
      if constexpr (C == 3) {
        if (sd == small) {
          const float4 p = a.panel[r];
          v[0] = p.x;
          v[1] = p.y;
          v[2] = p.z;
        }
      } else {
        if (sd == 0 || sd == 1) {
          const float4 p = a.panel[r];
          const bool right = sd == 1;
          v[0] = right ? 0.f : p.x;
          v[1] = right ? 0.f : p.y;
          v[2] = right ? 0.f : p.z;
          v[3] = right ? p.x : 0.f;
          v[4] = right ? p.y : 0.f;
          v[5] = right ? p.z : 0.f;
        }
      }
    }
    // inclusive scan of each run of equal keys across the warp (the lanes'
    // keys ascend, so a run is a range of lanes)
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int k2 = __shfl_up_sync(kFull, key, o);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float u = __shfl_up_sync(kFull, v[c], o);
        if (lane >= o && k2 == key) v[c] = __fadd_rn(v[c], u);
      }
    }
    const int next = __shfl_down_sync(kFull, key, 1);
    if (key >= 0 && (lane == 31 || next != key)) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (v[c] != 0.f) atomicAdd(acc + key * C + c, v[c]);
    }
  }
}

template <int C>
__device__ void entries_block(const GArgs& a, float* acc, const int* it, int small,
                              bool* s_last) {
  const int f0 = it[0], f1 = it[1], e0 = it[2], e1 = it[3], slot = it[4], k = it[5];
  const int B = a.B, nf = f1 - f0, n_acc = nf * B * C;
  for (int i = threadIdx.x; i < n_acc; i += kThreads) acc[i] = 0.f;
  __syncthreads();
  sum_entries<C>(a, acc, e0, e1, f0 * B, small);
  __syncthreads();
  if (slot >= 0) {  // heavy feature: merge the blocks' sums in its slot
    float* g = a.acc + (size_t)slot * B * 6;
    for (int i = threadIdx.x; i < n_acc; i += kThreads)
      if (acc[i] != 0.f) atomicAdd(g + i, acc[i]);
    if (!last_block(a.tickets + 1 + slot, k, s_last)) return;
    volatile float* vg = g;
    for (int i = threadIdx.x; i < n_acc; i += kThreads) {
      acc[i] = vg[i];
      vg[i] = 0.f;
    }
    if (threadIdx.x == 0) a.tickets[1 + slot] = 0;
    __syncthreads();
  }
  // each feature's zero bin += the side's total - the feature's stored cells
  for (int p = threadIdx.x; p < nf * C; p += kThreads) {
    const int j = p / C, c = p % C;
    const int sd = C == 3 ? small : c / 3;
    float* col = acc + (size_t)j * B * C + c;
    float sum = 0.f;
    for (int b = 0; b < B; ++b) sum = __fadd_rn(sum, col[b * C]);
    const int zb = a.zero_bin[f0 + j];
    col[zb * C] = __fadd_rn(col[zb * C], __fsub_rn(a.totals[3 * sd + c % 3], sum));
  }
  __syncthreads();
  const size_t slot_cells = (size_t)a.d * B * 3, first = (size_t)f0 * B * 3;
  const int n_out = nf * B * 3;
  if constexpr (C == 6) {
    for (int i = threadIdx.x; i < n_out; i += kThreads) {
      const int cell = i / 3, c = i % 3;
      a.out[first + i] = acc[cell * 6 + c];
      a.out[slot_cells + first + i] = acc[cell * 6 + 3 + c];
    }
  } else {
    float* mine = a.out + small * slot_cells + first;
    float* other = a.out + (1 - small) * slot_cells + first;
    const float* kept =
        a.parent == nullptr ? nullptr : a.parent + a.ctrl[1] * slot_cells + first;
    for (int i = threadIdx.x; i < n_out; i += kThreads) {
      mine[i] = acc[i];
      if (kept != nullptr) other[i] = __fsub_rn(kept[i], acc[i]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) sparse_entries_kernel(const GArgs a) {
  extern __shared__ __align__(16) float acc[];
  __shared__ bool s_last;
  const int* it = a.items + 6 * blockIdx.x;
  const int small = a.state[0];
  if (a.ctrl[0] != 0) {
    entries_block<3>(a, acc, it, small, &s_last);
  } else {
    entries_block<6>(a, acc, it, small, &s_last);
  }
}

}  // namespace

// Both passes, on a->device (made current for the launches if it is not),
// into `stream`, a stream of that device.
extern "C" int smt_sparse_hist(const GArgs* a, void* stream) {
  if (a->n < 0 || a->d < 0 || a->B < 1 || a->n_items < 0 || a->max_feats < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != a->device && (err = cudaSetDevice(a->device)) != cudaSuccess) return (int)err;
  LaunchFacts rows_lf, ent_lf;
  const int smem = a->max_feats * a->B * 6 * (int)sizeof(float);
  err = launch_facts((const void*)sparse_rows_kernel, kThreads, 0, &rows_lf);
  if (err == cudaSuccess)
    err = launch_facts((const void*)sparse_entries_kernel, kThreads, smem, &ent_lf);
  if (err == cudaSuccess) {
    int grid = (a->n + kThreads - 1) / kThreads;
    const int most = rows_lf.per_sm * rows_lf.sms;
    grid = grid < 1 ? 1 : (grid > most ? most : grid);
    sparse_rows_kernel<<<grid, kThreads, 0, s>>>(*a);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && a->n_items > 0) {
    sparse_entries_kernel<<<a->n_items, kThreads, smem, s>>>(*a);
    err = cudaGetLastError();
  }
  if (prev != a->device) cudaSetDevice(prev);
  return (int)err;
}

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
