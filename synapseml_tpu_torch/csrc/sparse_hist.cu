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
// so the sums may be taken in any order, with atomics, and both paths below
// give the plain version's bits.
//
// Inputs: the entries twice, sorted by cell = feature * B + bin (rows,
// cells) and in CSR order (row_cells, with row_ptr (n + 1,) int64), the
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
// Four launches a call, each of which reads the path from `state` and
// returns at once when it is the other one (nothing is read back to the
// host):
//   1. the rows pass: each side's panel sum, member rows and member entries
//      (row_ptr[r + 1] - row_ptr[r]), a register sum a thread over a
//      grid-stride of rows, block sums added into `rowsum` with atomics; the
//      last block to take a ticket (CUDA's threadFenceReduction pattern)
//      writes totals, the smaller side and the path into `state`, resets the
//      stream's queue and zeroes rowsum and its ticket. The row walk is
//      taken when the summed side(s) -- the smaller side in half mode, both
//      otherwise (a split leaf whose histograms were not kept: deep, so
//      small too) -- hold fewer than kWalkPerMille / 1000 of the nnz
//      entries; otherwise the stream.
//   2. the stream (a large side: the roots and near-root splits): a grid of
//      resident blocks takes the items of the host's plan (sparse.py::g_plan,
//      made once a SparseBinned, the most entries first) from a queue in
//      `state`. A light item is a run of whole features holding at most
//      G_ENTRIES entries; its block sums them into shared memory (features
//      x B x channels f32), adds each feature's residual and writes every
//      cell of its features with plain stores. A feature with more entries
//      is heavy: a block per G_ENTRIES of them adds its sums into the
//      feature's slot of `acc` with global atomics and takes the slot's
//      ticket; the last to arrive reads the slot, zeroes it and its ticket,
//      and writes the feature. A warp reads 32 consecutive entries a batch
//      (coalesced rows and cells), gathers each row's side and, for a
//      member, its 16-byte panel, and reduces runs of equal cells across the
//      warp (a segmented shuffle scan): a cell gets one shared-memory atomic
//      a run. Loads issued one or three batches ahead of the scan did not
//      make the stream faster on the H100 (PERF.md), so a batch's loads
//      precede its scan. The resident grid costs a walk call one early exit
//      a block.
//   3. the row walk (a small side): a fixed grid sized from the card's
//      occupancy strides over the rows, 128 a warp (one 16-byte load of side
//      a lane); each member row is walked by the whole warp, a lane an entry
//      of row_cells, its panel (one broadcast 16-byte load) added into a
//      (2, d * B, 4) f32 scratch (a side's cells, then the other's), zero
//      between calls: one float4 atomic an entry (sm_90's vector
//      atomicAdd). A row of weight 0 adds nothing and is skipped. Hashed
//      text's frequent words -- a stop word is in nearly every row, mostly
//      at count 1, so in one cell -- would serialise those atomics on a few
//      cells, so the hottest features (the most entries, from `counts` when
//      the plan is made; sparse.py::g_hot) get a slice of each block's
//      shared memory (hot x B x 3 f32; the hotter half of them at 6
//      channels when both sides are summed): their entries take
//      shared-memory atomics, and a block adds its slice into the scratch
//      once, at its end (a float4 atomic a non-zero cell). Chosen over
//      warp-aggregated adds (__match_any_sync): a warp walks one row, whose
//      entries are distinct cells, so lanes never share a cell to
//      aggregate. Each feature the walk adds to gets a byte in `touched` (a
//      plain store: a bit would need an atomic an entry).
//   4. the row walk's epilogue, dense over features (tiles of kTileFeats
//      features a block, 16-byte stores): a touched feature's cells are its
//      scratch plus the zero-bin residual; an untouched one's are 0, its
//      zero bin the side's total, without reading the scratch. It writes
//      out[small] (both slots with half = 0), the sibling parent[slot] -
//      out[small] when `parent` is given, and zeroes the scratch and the
//      flags it read.
// Every output cell is written once a call, with no zeroing launch; a call
// leaves acc, scratch, touched, rowsum and the tickets zero again.
//
// Bound on the H100: bytes. A call must read every row's side (4 B), the
// members' panel (the totals) and the summed rows' row_ptr (in distinct
// 32-byte sectors) and entries (4 B a cell), zero_bin, write the (2, d, B,
// 3) output (half mode with `parent`: read one slot of it too). The stream
// reads every entry's row and cell (8 B) instead, which is why it serves
// only large sides.

#include <cuda_runtime.h>
#include <stdint.h>

#include "occupancy.cuh"

// Field for field the _GArgs of gbdt/sparse.py. Outside the unnamed
// namespace: smt_sparse_hist takes it.
struct GArgs {
  const int* rows;           // (nnz,) row of each entry, entries sorted by cell
  const int* cells;          // (nnz,) feature * B + bin
  const int* row_cells;      // (nnz,) the same cells in CSR order
  const long long* row_ptr;  // (n + 1,) each row's first entry of row_cells
  const int* side;           // (n,)
  const float4* panel;       // (n,) [g*w, h*w, w, 0]
  const int* zero_bin;       // (d,)
  const int* items;          // (n_items, 6): f0, f1, e0, e1, heavy slot or -1, blocks of the slot
  const unsigned char* hot;  // (d,) 0, or 1 + the feature's slot in the walk's shared slice
  const int* hot_feats;      // (n_hot,) the feature of each hot slot
  float* acc;                // (heavy, B, 6) heavy features' sums, zero between calls
  int* tickets;              // (heavy + 1,) the rows pass's, then each heavy slot's
  float* rowsum;             // (10,) the sides' 6 sums, 2 member counts, 2 entry counts (int bits)
  int* state;                // (3,) the smaller side, the path, the stream's next item
  unsigned char* touched;    // (d,) features the walk added to, zero between calls
  float* scratch;            // (2, d * B, 4) the walk's sums, zero between calls
  const int* ctrl;           // (3,) half, slot, forced
  float* out;                // (2, d, B, 3)
  float* totals;             // (2, 3)
  const float* parent;       // (2, d, B, 3) or null
  int n, d, B, nnz, n_items, max_feats, n_hot, device;
};

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the row walk serves a call whose summed side(s) hold fewer than this many
// thousandths of the entries (sparse.py::G_WALK_PER_MILLE mirrors it)
constexpr int kWalkPerMille = 250;
constexpr int kPathStream = 0;
constexpr int kPathWalk = 1;
constexpr int kTileFeats = 64;  // features a tile of the epilogue

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

template <int C>
__device__ __forceinline__ bool is_member(int sd, int small) {
  return C == 3 ? sd == small : (sd == 0 || sd == 1);
}

__global__ void __launch_bounds__(kThreads) sparse_rows_kernel(const GArgs a) {
  __shared__ float s_sum[kWarps][10];
  __shared__ bool s_last;
  float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int c0 = 0, c1 = 0, n0 = 0, n1 = 0;
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < a.n; r += gridDim.x * blockDim.x) {
    const int sd = a.side[r];
    if (sd == 0) {
      const float4 p = a.panel[r];
      v[0] = __fadd_rn(v[0], p.x);
      v[1] = __fadd_rn(v[1], p.y);
      v[2] = __fadd_rn(v[2], p.z);
      ++c0;
      n0 += (int)(a.row_ptr[r + 1] - a.row_ptr[r]);
    } else if (sd == 1) {
      const float4 p = a.panel[r];
      v[3] = __fadd_rn(v[3], p.x);
      v[4] = __fadd_rn(v[4], p.y);
      v[5] = __fadd_rn(v[5], p.z);
      ++c1;
      n1 += (int)(a.row_ptr[r + 1] - a.row_ptr[r]);
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < 6; ++k) v[k] = __fadd_rn(v[k], __shfl_down_sync(kFull, v[k], o));
    c0 += __shfl_down_sync(kFull, c0, o);
    c1 += __shfl_down_sync(kFull, c1, o);
    n0 += __shfl_down_sync(kFull, n0, o);
    n1 += __shfl_down_sync(kFull, n1, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < 6; ++k) s_sum[warp][k] = v[k];
    s_sum[warp][6] = __int_as_float(c0);
    s_sum[warp][7] = __int_as_float(c1);
    s_sum[warp][8] = __int_as_float(n0);
    s_sum[warp][9] = __int_as_float(n1);
  }
  __syncthreads();
  if (threadIdx.x < 10) {
    const int k = threadIdx.x;
    if (k < 6) {
      float t = 0.f;
      for (int w = 0; w < kWarps; ++w) t = __fadd_rn(t, s_sum[w][k]);
      if (t != 0.f) atomicAdd(a.rowsum + k, t);
    } else {
      int t = 0;
      for (int w = 0; w < kWarps; ++w) t += __float_as_int(s_sum[w][k]);
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
    const int n_left = cnt[0], n_right = cnt[1], e_left = cnt[2], e_right = cnt[3];
    for (int k = 0; k < 4; ++k) cnt[k] = 0;
    const int forced = a.ctrl[2];
    const int small = forced >= 0 ? forced : (n_right <= n_left ? 1 : 0);
    const long long summed =
        a.ctrl[0] != 0 ? (long long)(small ? e_right : e_left) : (long long)e_left + e_right;
    a.state[0] = small;
    a.state[1] = summed * 1000 < (long long)a.nnz * kWalkPerMille ? kPathWalk : kPathStream;
    a.state[2] = 0;  // the stream's item queue
    a.tickets[0] = 0;
  }
}

// ---------------------------------------------------------------------------
// The stream
// ---------------------------------------------------------------------------

// One warp batch of 32 entries (lane: key = cell - base_cell or -1, the row's
// side and panel) into acc, runs of equal keys reduced across the warp.
template <int C>
__device__ __forceinline__ void scan_batch(float* acc, int key, float4 p, int sd, int small,
                                           int lane) {
  float v[C];
  // constant register indices: a computed one would put v in local memory
  if constexpr (C == 3) {
    const bool m = key >= 0 && sd == small;
    v[0] = m ? p.x : 0.f;
    v[1] = m ? p.y : 0.f;
    v[2] = m ? p.z : 0.f;
  } else {
    const bool left = key >= 0 && sd == 0, right = key >= 0 && sd == 1;
    v[0] = left ? p.x : 0.f;
    v[1] = left ? p.y : 0.f;
    v[2] = left ? p.z : 0.f;
    v[3] = right ? p.x : 0.f;
    v[4] = right ? p.y : 0.f;
    v[5] = right ? p.z : 0.f;
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

// The block's entries [e0, e1) into acc (cells of features f0.., C channels
// a cell): C = 6, both sides; C = 3, side `small` only. A warp takes 32
// consecutive entries a batch, kThreads apart.
template <int C>
__device__ void sum_entries(const GArgs& a, float* acc, int e0, int e1, int base_cell,
                            int small) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int start = e0 + warp * 32; start < e1; start += kThreads) {
    const int e = start + lane;
    int key = -1, sd = -1;
    float4 p = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e < e1) {
      key = a.cells[e] - base_cell;
      const int r = a.rows[e];
      sd = a.side[r];
      if (is_member<C>(sd, small)) p = a.panel[r];
    }
    scan_batch<C>(acc, key, p, sd, small, lane);
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
  if (a.state[1] != kPathStream) return;
  extern __shared__ __align__(16) float acc[];
  __shared__ bool s_last;
  __shared__ int s_item;
  const int small = a.state[0];
  const bool half = a.ctrl[0] != 0;
  for (;;) {  // the next item of the queue (the plan lists the most entries first)
    if (threadIdx.x == 0) s_item = atomicAdd(a.state + 2, 1);
    __syncthreads();
    const int item = s_item;
    if (item >= a.n_items) return;
    const int* it = a.items + 6 * item;
    if (half) {
      entries_block<3>(a, acc, it, small, &s_last);
    } else {
      entries_block<6>(a, acc, it, small, &s_last);
    }
    __syncthreads();  // the next item reuses acc and s_item
  }
}

// ---------------------------------------------------------------------------
// The row walk and its epilogue
// ---------------------------------------------------------------------------

// Member row r (side sd) walked by the whole warp, a lane an entry.
template <int C>
__device__ __forceinline__ void walk_row(const GArgs& a, float* hot, int n_hot, int r, int sd,
                                         int lane) {
  const float4 p = a.panel[r];
  if (p.x == 0.f && p.y == 0.f && p.z == 0.f) return;  // adds only zeros
  const int B = a.B;
  const int hoff = C == 3 ? 0 : 3 * sd;
  float4* sc = reinterpret_cast<float4*>(a.scratch) + (C == 3 ? 0 : (size_t)sd * a.d * B);
  const float4 add = make_float4(p.x, p.y, p.z, 0.f);
  const long long end = a.row_ptr[r + 1];
  for (long long e = a.row_ptr[r] + lane; e < end; e += 32) {
    const int cell = a.row_cells[e];
    const int f = cell / B;
    const int h = a.hot[f];
    if (h != 0 && h <= n_hot) {
      float* q = hot + ((h - 1) * B + (cell - f * B)) * C + hoff;
      atomicAdd(q, p.x);
      atomicAdd(q + 1, p.y);
      atomicAdd(q + 2, p.z);
    } else {
      atomicAdd(sc + cell, add);
      a.touched[f] = 1;
    }
  }
}

template <int C>
__device__ void walk(const GArgs& a, float* hot, int small, int* s_any) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the slice holds n_hot features at 3 channels, half of them at 6
  const int n_hot = C == 3 ? a.n_hot : a.n_hot / 2;
  const int B = a.B, n_hot_cells = n_hot * B * C;
  for (int i = threadIdx.x; i < n_hot_cells; i += kThreads) hot[i] = 0.f;
  if (threadIdx.x == 0) *s_any = 0;
  __syncthreads();
  const bool vec = (reinterpret_cast<uintptr_t>(a.side) & 15) == 0;
  const int chunks = (a.n + 127) / 128;
  bool any = false;
  for (int ch = blockIdx.x * kWarps + warp; ch < chunks; ch += gridDim.x * kWarps) {
    const int r0 = ch * 128 + 4 * lane;
    int sv[4];
    if (vec && r0 + 3 < a.n) {
      const int4 q = *reinterpret_cast<const int4*>(a.side + r0);
      sv[0] = q.x;
      sv[1] = q.y;
      sv[2] = q.z;
      sv[3] = q.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) sv[k] = r0 + k < a.n ? a.side[r0 + k] : -1;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      unsigned ball = __ballot_sync(kFull, is_member<C>(sv[k], small));
      any = any || ball != 0;
      while (ball) {
        const int l = __ffs(ball) - 1;
        ball &= ball - 1;
        walk_row<C>(a, hot, n_hot, ch * 128 + 4 * l + k, __shfl_sync(kFull, sv[k], l), lane);
      }
    }
  }
  if (any && lane == 0) *s_any = 1;
  __syncthreads();
  if (*s_any == 0) return;
  // the block's hot slice into the scratch, once: a float4 a cell and side
  float4* sc = reinterpret_cast<float4*>(a.scratch);
  const size_t side_cells = (size_t)a.d * B;
  for (int i = threadIdx.x; i < n_hot * B; i += kThreads) {
    const int slot = i / B, b = i - slot * B;
    const int f = a.hot_feats[slot];
#pragma unroll
    for (int s = 0; s < C / 3; ++s) {
      const float* v = hot + i * C + 3 * s;
      if (v[0] != 0.f || v[1] != 0.f || v[2] != 0.f) {
        atomicAdd(sc + s * side_cells + (size_t)f * B + b, make_float4(v[0], v[1], v[2], 0.f));
        a.touched[f] = 1;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) sparse_walk_kernel(const GArgs a) {
  if (a.state[1] != kPathWalk) return;
  extern __shared__ __align__(16) float hot[];
  __shared__ int s_any;
  if (a.ctrl[0] != 0) {
    walk<3>(a, hot, a.state[0], &s_any);
  } else {
    walk<6>(a, hot, -1, &s_any);
  }
}

__global__ void __launch_bounds__(kThreads) sparse_epilogue_kernel(const GArgs a) {
  if (a.state[1] != kPathWalk) return;
  __shared__ float s_res[kTileFeats][6];
  __shared__ int s_zb[kTileFeats];
  __shared__ int s_touch[kTileFeats];
  const bool half = a.ctrl[0] != 0;
  const int small = a.state[0], B = a.B;
  const int first = half ? small : 0;  // the (first) slot written from the scratch
  const size_t side_cells = (size_t)a.d * B, slot_cells = side_cells * 3;
  const float* kept =
      half && a.parent != nullptr ? a.parent + (size_t)a.ctrl[1] * slot_cells : nullptr;
  float* out0 = a.out + first * slot_cells;
  float* out1 = a.out + (half ? 1 - small : 1) * slot_cells;
  float4* sc = reinterpret_cast<float4*>(a.scratch);
  // 16-byte stores when every slot (and the kept one) starts on 16 bytes
  const bool vec = (slot_cells & 3) == 0 && (reinterpret_cast<uintptr_t>(a.out) & 15) == 0 &&
                   (kept == nullptr || (reinterpret_cast<uintptr_t>(kept) & 15) == 0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tiles = (a.d + kTileFeats - 1) / kTileFeats;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int f0 = t * kTileFeats, nf = min(kTileFeats, a.d - f0);
    const size_t cell0 = (size_t)f0 * B;
    if (threadIdx.x < nf) {
      s_touch[threadIdx.x] = a.touched[f0 + threadIdx.x];
      s_zb[threadIdx.x] = a.zero_bin[f0 + threadIdx.x];
    }
    __syncthreads();
    // each feature's residual: the side's total - its cells (a warp a feature)
    for (int j = warp; j < nf; j += kWarps) {
      float s[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (s_touch[j]) {
        for (int b = lane; b < B; b += 32) {
          const float4 lo = sc[cell0 + j * B + b];
          s[0] = __fadd_rn(s[0], lo.x);
          s[1] = __fadd_rn(s[1], lo.y);
          s[2] = __fadd_rn(s[2], lo.z);
          if (!half) {
            const float4 hi = sc[side_cells + cell0 + j * B + b];
            s[3] = __fadd_rn(s[3], hi.x);
            s[4] = __fadd_rn(s[4], hi.y);
            s[5] = __fadd_rn(s[5], hi.z);
          }
        }
        for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
          for (int k = 0; k < 6; ++k) s[k] = __fadd_rn(s[k], __shfl_xor_sync(kFull, s[k], o));
        }
      }
      float mine = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k)
        if (lane == k) mine = s[k];
      if (lane < (half ? 3 : 6))
        s_res[j][lane] = __fsub_rn(a.totals[3 * (half ? small : lane / 3) + lane % 3], mine);
    }
    __syncthreads();
    // output float q of the tile (cell q / 3, channel q % 3), for side s of
    // the scratch: the cell's sum, plus the residual at the zero bin
    auto value = [&](int j, int b, int cell, int c, int s) {
      float v = 0.f;
      if (s_touch[j]) {
        const float* f = reinterpret_cast<const float*>(sc + s * side_cells + cell0 + cell);
        v = f[c];
      }
      return b == s_zb[j] ? __fadd_rn(v, s_res[j][3 * s + c]) : v;
    };
    const int nq = nf * B * 3, nq4 = vec ? nq / 4 * 4 : 0;
    const size_t q0 = cell0 * 3;
    for (int q = 4 * threadIdx.x; q < nq4; q += 4 * kThreads) {
      int cell = q / 3, c = q - 3 * cell, j = cell / B, b = cell - j * B;
      float v[4], w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[k] = value(j, b, cell, c, 0);
        w[k] = half ? 0.f : value(j, b, cell, c, 1);
        if (++c == 3) {
          c = 0;
          ++cell;
          if (++b == B) {
            b = 0;
            ++j;
          }
        }
      }
      *reinterpret_cast<float4*>(out0 + q0 + q) = make_float4(v[0], v[1], v[2], v[3]);
      if (!half) {
        *reinterpret_cast<float4*>(out1 + q0 + q) = make_float4(w[0], w[1], w[2], w[3]);
      } else if (kept != nullptr) {
        const float4 k4 = *reinterpret_cast<const float4*>(kept + q0 + q);
        *reinterpret_cast<float4*>(out1 + q0 + q) =
            make_float4(__fsub_rn(k4.x, v[0]), __fsub_rn(k4.y, v[1]), __fsub_rn(k4.z, v[2]),
                        __fsub_rn(k4.w, v[3]));
      }
    }
    for (int q = nq4 + threadIdx.x; q < nq; q += kThreads) {  // unaligned slots, ragged tail
      const int cell = q / 3, c = q - 3 * cell, j = cell / B, b = cell - j * B;
      const float v = value(j, b, cell, c, 0);
      out0[q0 + q] = v;
      if (!half) {
        out1[q0 + q] = value(j, b, cell, c, 1);
      } else if (kept != nullptr) {
        out1[q0 + q] = __fsub_rn(kept[q0 + q], v);
      }
    }
    __syncthreads();
    // the scratch and the flags this tile read, zero for the next call
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = threadIdx.x; p < nf * B; p += kThreads) {
      if (s_touch[p / B]) {
        sc[cell0 + p] = zero;
        if (!half) sc[side_cells + cell0 + p] = zero;
      }
    }
    if (threadIdx.x < nf && s_touch[threadIdx.x]) a.touched[f0 + threadIdx.x] = 0;
    __syncthreads();
  }
}

int clamp_grid(long long want, const LaunchFacts& lf) {
  const long long most = (long long)lf.per_sm * lf.sms;
  return (int)(want < 1 ? 1 : (want > most ? most : want));
}

}  // namespace

// The four launches, on a->device (made current for the launches if it is
// not), into `stream`, a stream of that device.
extern "C" int smt_sparse_hist(const GArgs* a, void* stream) {
  if (a->n < 0 || a->d < 0 || a->B < 1 || a->nnz < 0 || a->n_items < 0 || a->max_feats < 1 ||
      a->n_hot < 0 || a->n_hot > 255)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != a->device && (err = cudaSetDevice(a->device)) != cudaSuccess) return (int)err;
  LaunchFacts rows_lf, ent_lf, walk_lf, epi_lf;
  const int ent_smem = a->max_feats * a->B * 6 * (int)sizeof(float);
  const int walk_smem = a->n_hot * a->B * 3 * (int)sizeof(float);
  err = launch_facts((const void*)sparse_rows_kernel, kThreads, 0, &rows_lf);
  if (err == cudaSuccess)
    err = launch_facts((const void*)sparse_entries_kernel, kThreads, ent_smem, &ent_lf);
  if (err == cudaSuccess)
    err = launch_facts((const void*)sparse_walk_kernel, kThreads, walk_smem, &walk_lf);
  if (err == cudaSuccess)
    err = launch_facts((const void*)sparse_epilogue_kernel, kThreads, 0, &epi_lf);
  if (err == cudaSuccess) {
    sparse_rows_kernel<<<clamp_grid(((long long)a->n + kThreads - 1) / kThreads, rows_lf),
                         kThreads, 0, s>>>(*a);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    sparse_entries_kernel<<<clamp_grid(a->n_items, ent_lf), kThreads, ent_smem, s>>>(*a);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    const long long chunks = ((long long)a->n + 127) / 128;
    sparse_walk_kernel<<<clamp_grid((chunks + kWarps - 1) / kWarps, walk_lf), kThreads,
                         walk_smem, s>>>(*a);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) {
    sparse_epilogue_kernel<<<clamp_grid(((long long)a->d + kTileFeats - 1) / kTileFeats,
                                        epi_lf),
                             kThreads, 0, s>>>(*a);
    err = cudaGetLastError();
  }
  if (prev != a->device) cudaSetDevice(prev);
  return (int)err;
}

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
