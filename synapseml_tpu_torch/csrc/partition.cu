// Kernel P: the row partition of a growth step (LightGBM's DataPartition).
//
// Replaces: synapseml_tpu/gbdt/grow.py::grow_tree's leaf-local branch, the
// row routing of a step (grow.py:384-388: column gather, in_set lookup,
// node update) and the member counts and smaller-child choice (:389-403)
// that feed leaf_hist_local's cumsum-scatter compaction (:223-250). The
// reference finds a leaf's rows by scanning all n rows; here they are kept
// grouped by leaf, so a step reads only the rows of the leaf it splits.
//
// State, on the card for the whole tree:
//   ids   (2, n) int32 two buffers of row ids; each leaf's rows are the
//                      slice [begin, begin + count) of one of them;
//   seg   (L, 2) int32 (begin, count) of each leaf's slice;
//   side  (L,)   int32 the buffer (0 or 1) that holds each leaf's slice;
//   node  (n,)   int32 each row's leaf (the reference's node_of_row).
// At the tree's start ids[0] = 0..n-1, seg[0] = (0, n), side[0] = 0.
//
// One launch splits leaf l = choice[0] on feature f = choice[1], as kernel
// E decided it (choice, ok, in_set are E's outputs, read here from device
// memory, so the host never reads a count). Each row of l's slice goes left
// iff in_set[bins[row, f]] (a bin outside [0, B) goes right, as in
// predict_binned). The rows are read from buffer side[l] and written into
// the same range [begin, begin + count) of the other buffer, which no leaf
// holds (the ranges of the leaves are disjoint): left rows from the front,
// right rows from the back, at offsets from one atomicAdd a block tile (a
// warp scan and a block scan give every thread its offset); right rows get
// node = s + 1. Both children then
// live in the other buffer. Nothing is copied back, so each routed id is
// read once and written once.
//
// The step ends in the last block to finish (CUDA's threadFenceReduction
// pattern): every block fences its counter updates and takes a ticket of a
// per-step arrival counter; the block that takes the last ticket reads the
// final left count and writes seg[l] = (begin, n_left), seg[s + 1] =
// (begin + n_left, n_right), both children's side, and the smaller child by
// the reference's rule (right iff n_right <= n_left, grow.py:397; counts of
// member rows, weight 0 included) into small = (begin, count, buffer) and
// smaller_right, which kernel A's row-list entry reads. No block waits for
// another, so the launch is an ordinary one, and no block is held resident.
// An inert step (!ok) changes nothing and records an empty smaller child on
// the right, as the reference's counts (0 <= 0) do.
//
// The mesh entry (mesh = 1, gbdt/partition.py::RowPartition.split with
// mesh=True): on a data-parallel mesh each rank holds a block of the rows,
// and the smaller child must be the one with fewer rows over ALL ranks (the
// reference all-reduces the counts, grow.py:393-396): each rank histograms
// its local rows of the same side, and the all-reduced child is the global
// child's histogram. So the launch routes and counts as above, but its last
// block writes this rank's (n_left, n_right) into `counts` and leaves
// `small` and `smaller_right` alone (an inert step writes (0, 0)). The
// caller all-reduces `counts` (one collective of two int32), then launches
// smt_partition_pick: one thread that sets smaller_right from the global
// counts (right iff n_right <= n_left) and `small` to that child's LOCAL
// slice (begin, count, buffer), read from seg and side. Without a mesh the
// one-launch step above stays as it is.
//
// Work is sized on the card: the host launches an occupancy-sized grid (the
// leaf's count exists only on the card), and each block computes from the
// count how many blocks have tiles, active = max(1, min(grid, tiles)). A
// block past it returns before any shared-memory or atomic work and takes no
// ticket, so a 40-row leaf costs one block's work. Every block computes the
// same `active`: it reads seg[l] before the last block rewrites it, or, if it
// starts later than that, reads n_left <= count, which gives an active count
// no larger, and it returns all the same.
//
// The order of rows inside a slice is not kept (the atomics decide it): the
// histogram sums are exact on _preround's grid in any order.
//
// Bound on the H100: bytes. Per row of the split leaf: its id read once and
// written once (4 B each, coalesced), its bin gathered (the distinct 32-byte
// sectors the leaf's rows touch) and, for a right row, node written (also
// counted in sectors). The grid: at most kMaxBlocksPerSm blocks an SM, so
// that enough bin gathers are in flight at a large leaf (PERF.md, the P
// sweep); a block reserves kWarps * 4 + 12 bytes of static shared memory and
// 256 threads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "occupancy.cuh"

// Field for field the _PartArgs of gbdt/partition.py. Declared outside the
// unnamed namespace: smt_partition takes it, and a C entry point whose
// parameter has internal linkage is not exported.
struct PartArgs {
  const void* bins;           // (n, d) int8 / int16 / int32
  int* ids;                   // (2, n)
  int* seg;                   // (L, 2)
  int* side;                  // (L,)
  int* counters;              // (L - 1, 3): left rows, right rows, blocks arrived
  int* node;                  // (n,)
  const long long* choice;    // (2,): leaf, feature
  const int8_t* ok;           // (1,)
  const int8_t* in_set;       // (B,)
  int* small;                 // (3,): begin, count, buffer of the smaller child
  int8_t* smaller_right;      // (1,)
  int* counts;                // (2,): the mesh entry's (n_left, n_right), then global
  long long n;
  int d;
  int n_bins;
  int s;
  int device;                 // the card the tensors live on
  int mesh;                   // 1: the mesh entry (counts out, no choice of side)
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;                     // rows a thread routes a tile
constexpr int kTile = kThreads * kPerThread;      // rows a block routes a tile
constexpr int kMaxBlocksPerSm = 4;                // cap on the occupancy-sized grid
constexpr unsigned kAll = 0xffffffffu;


// Block-wide exclusive scan of v (left count in the low 16 bits, right count
// in the high 16: at most kTile < 2^16 each); returns the thread's offset,
// and the block's total in *total.
__device__ int block_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kAll, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int y = __shfl_up_sync(kAll, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;  // inclusive prefix over warps
  }
  __syncthreads();
  const int before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[kWarps - 1];
  return before + x - v;
}

template <typename BinT>
__global__ void __launch_bounds__(kThreads) partition_kernel(PartArgs a) {
  __shared__ int warp_sums[kWarps];
  __shared__ int base[2];
  __shared__ int last;
  // ok and the choice are loaded together (a small leaf's time is its chain
  // of dependent loads)
  const bool ok = a.ok[0] != 0;
  const int l = (int)a.choice[0], f = (int)a.choice[1];
  if (!ok) {  // an inert step: block 0 records the empty smaller child
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      if (a.mesh) {
        a.counts[0] = 0;
        a.counts[1] = 0;
      } else {
        a.small[0] = 0;
        a.small[1] = 0;
        a.small[2] = 0;
        a.smaller_right[0] = 1;
      }
    }
    return;
  }
  const int begin = a.seg[2 * l], count = a.seg[2 * l + 1], from = a.side[l];
  const int tiles = (count + kTile - 1) / kTile;
  const int active = max(1, min((int)gridDim.x, tiles));
  if ((int)blockIdx.x >= active) return;  // before any shared-memory or atomic work

  const int to = 1 - from;
  int* cnt = a.counters + 3 * a.s;
  const BinT* bins = (const BinT*)a.bins;
  const int* in = a.ids + from * a.n + begin;
  int* out = a.ids + to * a.n + begin;

  for (int t = blockIdx.x; t < tiles; t += active) {
    const long long t0 = (long long)t * kTile;
    int row[kPerThread];
    bool valid[kPerThread], left[kPerThread];
    int nl = 0, nr = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const long long i = t0 + k * kThreads + threadIdx.x;
      valid[k] = i < count;
      row[k] = valid[k] ? __ldg(in + i) : 0;  // this launch writes only `out`
    }
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int b = valid[k] ? (int)__ldg(bins + (long long)row[k] * a.d + f) : -1;
      left[k] = valid[k] && b >= 0 && b < a.n_bins && a.in_set[b] != 0;
      nl += valid[k] && left[k];
      nr += valid[k] && !left[k];
    }
    int total;
    const int off = block_scan(nl | (nr << 16), warp_sums, &total);
    if (threadIdx.x == 0) {
      base[0] = atomicAdd(cnt, total & 0xffff);
      base[1] = atomicAdd(cnt + 1, total >> 16);
    }
    __syncthreads();
    int pl = base[0] + (off & 0xffff), pr = base[1] + (off >> 16);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (!valid[k]) continue;
      if (left[k]) {
        out[pl++] = row[k];
      } else {
        out[count - 1 - pr++] = row[k];
        a.node[row[k]] = a.s + 1;
      }
    }
    __syncthreads();  // warp_sums and base are reused by the next tile
  }

  // the last active block to arrive finishes the step
  if (threadIdx.x == 0) {
    __threadfence();  // this block's counter updates before its ticket
    last = atomicAdd(cnt + 2, 1) == active - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  const int n_left = *(volatile int*)cnt, n_right = count - n_left;
  const int r = a.s + 1;
  a.seg[2 * l + 1] = n_left;
  a.seg[2 * r] = begin + n_left;
  a.seg[2 * r + 1] = n_right;
  a.side[l] = to;
  a.side[r] = to;
  if (a.mesh) {  // the choice waits for the all-reduced counts (smt_partition_pick)
    a.counts[0] = n_left;
    a.counts[1] = n_right;
    return;
  }
  const bool right_smaller = n_right <= n_left;
  a.small[0] = right_smaller ? begin + n_left : begin;
  a.small[1] = right_smaller ? n_right : n_left;
  a.small[2] = to;
  a.smaller_right[0] = (int8_t)right_smaller;
}

// The mesh entry's second launch: the smaller child from the global counts
// (right iff n_right <= n_left), and `small` = that child's local slice.
__global__ void pick_kernel(PartArgs a) {
  if (a.ok[0] == 0) {
    a.small[0] = 0;
    a.small[1] = 0;
    a.small[2] = 0;
    a.smaller_right[0] = 1;
    return;
  }
  const bool right_smaller = a.counts[1] <= a.counts[0];
  const int c = right_smaller ? a.s + 1 : (int)a.choice[0];
  a.small[0] = a.seg[2 * c];
  a.small[1] = a.seg[2 * c + 1];
  a.small[2] = a.side[c];
  a.smaller_right[0] = (int8_t)right_smaller;
}

template <typename BinT>
cudaError_t launch(PartArgs* a, cudaStream_t stream) {
  auto kern = partition_kernel<BinT>;
  LaunchFacts lf;
  cudaError_t err = launch_facts((const void*)kern, kThreads, 0, &lf);
  if (err != cudaSuccess) return err;
  const int per_sm = kMaxBlocksPerSm < lf.per_sm ? kMaxBlocksPerSm : lf.per_sm;
  kern<<<per_sm * lf.sms, kThreads, 0, stream>>>(*a);
  return cudaGetLastError();
}

}  // namespace

// Launches on a->device (made current for the launch if it is not), into
// `stream`, a stream of that device.
extern "C" int smt_partition(PartArgs* a, int bin_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != a->device && (err = cudaSetDevice(a->device)) != cudaSuccess) return (int)err;
  switch (bin_bytes) {
    case 1: err = launch<int8_t>(a, s); break;
    case 2: err = launch<int16_t>(a, s); break;
    case 4: err = launch<int32_t>(a, s); break;
    default: err = cudaErrorInvalidValue;
  }
  if (prev != a->device) cudaSetDevice(prev);
  return (int)err;
}

// The mesh entry's pick (after the caller all-reduced a->counts), one thread
// on a->device, into `stream`.
extern "C" int smt_partition_pick(PartArgs* a, void* stream) {
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != a->device && (err = cudaSetDevice(a->device)) != cudaSuccess) return (int)err;
  pick_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(*a);
  err = cudaGetLastError();
  if (prev != a->device) cudaSetDevice(prev);
  return (int)err;
}

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
