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
//   order (n,) int32  row ids grouped by leaf;
//   seg   (L, 2) int32 (begin, count) of each leaf's slice of order;
//   node  (n,) int32  each row's leaf (the reference's node_of_row).
// At the tree's start order = 0..n-1 and seg[0] = (0, n).
//
// One launch splits leaf l = choice[0] on feature f = choice[1], as kernel
// E decided it (choice, ok, in_set are E's outputs, read here from device
// memory, so the host never reads a count). Each row of l's slice goes left
// iff in_set[bins[row, f]] (a bin outside [0, B) goes right, as in
// predict_binned); left rows are written to the front of the same slice of
// a scratch array, right rows to its back, at offsets from one atomicAdd a
// block tile (each warp counts its lanes with a ballot, a block scan gives
// every thread its offset); right rows get node = s + 1. After a grid-wide
// barrier the slice is copied back into order, and one thread sets
// seg[l] = (begin, n_left), seg[s + 1] = (begin + n_left, n_right) and the
// smaller child by the reference's rule (right iff n_right <= n_left,
// grow.py:397; counts of member rows, weight 0 included) into small =
// (begin, count) and smaller_right, which kernel A's row-list entry reads.
// An inert step (!ok) changes nothing and records an empty smaller child
// on the right, as the reference's counts (0 <= 0) do.
//
// The order of rows inside a slice is not kept (the atomics decide it): the
// histogram sums are exact on _preround's grid in any order.
//
// Bound on the H100: bytes. Per row of the split leaf: its id read twice
// and written twice (4 B each, coalesced), its bin gathered (one 32-byte
// sector per row, the rows' order being arbitrary) and, for a right row,
// node written (a 32-byte sector). The grid is sized by the occupancy
// calculator, at most kMaxBlocksPerSm blocks an SM, and launched
// cooperatively, so every block is resident and the barrier (one atomic a
// block and a spin on a per-step counter) is safe; the grid does not depend
// on the leaf's size, which stays on the card. A block reserves
// 2 * kWarps * 4 + 8 bytes of static shared memory and 256 threads; two
// blocks an SM (264 on 132 SMs) keep 270k row loads in flight, and the
// barrier costs about one atomic a block. Scratch holds n ids, the largest
// slice (the root's).

#include <cuda_runtime.h>
#include <stdint.h>

// Field for field the _PartArgs of gbdt/partition.py. Declared outside the
// unnamed namespace: smt_partition takes it, and a C entry point whose
// parameter has internal linkage is not exported.
struct PartArgs {
  const void* bins;           // (n, d) int8 / int16 / int32
  int* order;                 // (n,)
  int* scratch;               // (n,)
  int* seg;                   // (L, 2)
  int* counters;              // (L - 1, 3): left rows, right rows, blocks arrived
  int* node;                  // (n,)
  const long long* choice;    // (2,): leaf, feature
  const int8_t* ok;           // (1,)
  const int8_t* in_set;       // (B,)
  int* small;                 // (2,): begin, count of the smaller child
  int8_t* smaller_right;      // (1,)
  long long n;
  int d;
  int n_bins;
  int s;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;                     // rows a thread routes a tile
constexpr int kTile = kThreads * kPerThread;      // rows a block routes a tile
constexpr int kMaxBlocksPerSm = 2;
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
  if (!a.ok[0]) {  // the same for every block: none waits at the barrier
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      a.small[0] = 0;
      a.small[1] = 0;
      a.smaller_right[0] = 1;
    }
    return;
  }
  const int l = (int)a.choice[0];
  const int f = (int)a.choice[1];
  const int begin = a.seg[2 * l], count = a.seg[2 * l + 1];
  int* cnt = a.counters + 3 * a.s;
  const BinT* bins = (const BinT*)a.bins;
  const int* ids = a.order + begin;
  int* out = a.scratch + begin;

  for (long long t0 = (long long)blockIdx.x * kTile; t0 < count;
       t0 += (long long)gridDim.x * kTile) {
    int row[kPerThread];
    bool valid[kPerThread], left[kPerThread];
    int nl = 0, nr = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const long long i = t0 + k * kThreads + threadIdx.x;
      valid[k] = i < count;
      row[k] = valid[k] ? __ldcg(ids + i) : 0;  // order is rewritten below
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

  // grid-wide barrier: every block is resident (cooperative launch)
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(cnt + 2, 1);
    while (*(volatile int*)(cnt + 2) < (int)gridDim.x) __nanosleep(32);
    __threadfence();
  }
  __syncthreads();

  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < count;
       i += (long long)gridDim.x * kThreads)
    a.order[begin + i] = __ldcg(out + i);

  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int n_left = *(volatile int*)cnt, n_right = count - n_left;
    const int r = a.s + 1;
    a.seg[2 * l + 1] = n_left;
    a.seg[2 * r] = begin + n_left;
    a.seg[2 * r + 1] = n_right;
    const bool right_smaller = n_right <= n_left;
    a.small[0] = right_smaller ? begin + n_left : begin;
    a.small[1] = right_smaller ? n_right : n_left;
    a.smaller_right[0] = (int8_t)right_smaller;
  }
}

template <typename BinT>
cudaError_t launch(PartArgs* a, cudaStream_t stream) {
  auto kern = partition_kernel<BinT>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, 0)) !=
      cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  if (per_sm > kMaxBlocksPerSm) per_sm = kMaxBlocksPerSm;
  void* args[] = {a};
  return cudaLaunchCooperativeKernel((const void*)kern, dim3(per_sm * sms), dim3(kThreads),
                                     args, 0, stream);
}

}  // namespace

extern "C" int smt_partition(PartArgs* a, int bin_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  switch (bin_bytes) {
    case 1: err = launch<int8_t>(a, s); break;
    case 2: err = launch<int16_t>(a, s); break;
    case 4: err = launch<int32_t>(a, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
