// Kernel V: minibatch steps of the VW linear learner (AdaGrad, VW's
// --normalized scales, L1/L2), in place on the learner's state: the
// batches [j0, j1) of a fit in one persistent launch.
//
// Replaces: synapseml_tpu/vw/learner.py::train_linear -> batch_step
// (:130-153), which XLA runs once a batch inside lax.scan (:156), the
// passes in a second scan (:261): a scatter max of |v| into the scales, the
// normalised prediction, the loss gradient, a scatter-add of the entries'
// gradients into a dense 2^b vector, AdaGrad over all 2^b slots, the bias
// step.
//
// The function, over a batch of B rows of K entries (idx, val), labels y,
// importance weights wt, and the state w, g2, s (2^b f32 each), b, bg2:
//   s[i]   = max(s[i], |v|) over the batch's entries of slot i;
//   bvn    = v / max(s[i], 1e-12);
//   pred_r = fma over k ascending of w[i_rk] * bvn_rk, from +0, then + b;
//   dl_r   = the loss's gradient at pred_r (exp through exp_f32 below);
//   g[i]   = (l2 ? l2 * w[i] : +0) + dl_r * bvn_rk for each entry of slot i,
//            added in row-major order (r ascending, then k);
//   g2[i]  = fma(g, g, g2[i]);  w[i] -= (lr * g) / sqrt(g2[i]);
//   with l1: w[i] = sign(w[i]) * max(|w[i]| - (lr * l1) / sqrt(g2[i]), 0);
//   gb = (pairwise sum of dl over the batch padded to P = 2^ceil(log2 B)
//        with zeros, neighbours paired at each level) / B;
//   bg2 = fma(gb, gb, bg2);  b -= (lr * gb) / sqrt(bg2).
// Each operation is rounded on its own (__f*_rn, IEEE division and square
// root), in the order vw/learner.py::batch_step_plain takes it, so the
// kernel gives the plain version's bits on the card and the CPU.
//
// With l1 = l2 = 0 (the sparse regime) a slot with no entry in the batch
// has g = +0 and keeps its bits (fma(0, 0, g2) = g2, w - (+0) = w), so only
// the batch's slots are written. With l1 or l2 set (the dense regime) every
// slot moves: a third phase updates the slots the batch did not touch.
//
// Padding. pad_examples pads each row to K with index 0 and value +0.0. At
// the hashed-text shape 35-40 % of a batch's entries are padding, all on
// slot 0. Such an entry (index 0 and value bits 0: a real entry of that
// kind acts the same) is skipped everywhere, and its effect is applied
// exactly once:
//   - in a prediction its term is fma(w[0], +0, acc): acc is never -0 (it
//     starts at +0, and a zero sum of non-zero terms is +0), so the term
//     leaves acc as it is unless w[0] is not finite (NaN); one such fma for
//     a row that had padding has the effect of all of them;
//   - in slot 0's gradient each padding entry of row r adds dl_r * (+0). A
//     zero term changes a sum only where the sum is zero: -0 (a sum started
//     at l2 * w[0] = -0, all terms -0) becomes +0 with one +0 term, and a
//     NaN term (dl_r not finite) makes it NaN. Which of those happens does
//     not depend on where the terms fall among the real ones. The rows phase
//     ORs into block 0's `flags` word (distributed shared-memory atomics,
//     so the order does not matter) bit 0 for a NaN term and bit 1 for a
//     +0 term; slot 0's owner reads it and adds one term with that effect
//     after its real entries.
// A skipped term of an ordered chain is a -0 addend (a product -0 * +0 in
// the fma chain): x + (-0) = x for every x, -0 and NaN included, so the
// chains run over whole groups of four without a test per entry.
//
// Order and plan. No float atomics: each slot's sum is one thread's chain
// in row-major order, each prediction one warp's chain in k order. The
// fit's plan (vw/learner.py::StepPlan, built once on the card: the batches
// are the same every pass) lists each batch's distinct slots, the short
// lists first (the longest first, so that a warp's threads walk lists of
// one length) and then the long ones (more than V_LONG_LIST entries):
// uslot, each slot's entries in row-major order
// (ent[useg[u]..useg[u+1]): place r * K + k within the batch, -1 for a
// stand-in that only puts slot 0 in the list; evals the entries' values),
// each slot's batch max |v| (umax), per entry its slot's umax (ebm, so the
// rows phase has the new scale of every entry without waiting for a
// scatter), each batch's first long list (ulong) and its slots and entries
// (bounds: u0, u1, e0, e1).
//
// One launch (one call of smt_vw_step, one count of VW_KERNEL) runs the
// batches [j0, j1) in one thread-block cluster of `ctas` blocks of 512
// threads, the state stepped batch after batch as j1 - j0 launches of one
// batch would. A batch is:
//   1. rows: a warp a row (block c takes the contiguous rows
//      [c * rpc, (c + 1) * rpc)): the lanes read idx, val, ebm and gather
//      the state of 128 entries at once, compute each entry's bvn, write
//      the live (w, bvn) pairs in k order into the warp's shared memory,
//      and every lane runs the same fma chain over them; the row's dl is stored
//      into every block's shared `dl` (distributed shared memory), its
//      padding flags into block 0's `flags`;
//   barrier.cluster, in two halves: between its arrive and its wait each
//   thread loads the plan and the state (s, w, g2) of its first slot list,
//   which the rows do not write;
//   2. slots: every block's last warp first sums dl pairwise in its own
//      shared memory (levels of 2^L in place, the last five by warp
//      shuffles with doubling offsets: a level-L sum is index i * 2^L from
//      i * 2^L and i * 2^L + 2^(L-1)) and steps its copy of the bias, the
//      same bits in every block; a short list a thread (its terms loaded
//      eight at a time, then added in order), a long list a warp (its
//      lanes compute 128 terms at once into shared memory, then every lane
//      adds them in order); then s, g2, w (and in the dense regime the
//      slot's mark, the batch's epoch);
//   barrier.cluster;
//   3. dense regime only: all 2^b slots, skipping the slots marked with
//      this batch's epoch (j - j0; every mark is -1 when a launch starts):
//      g = l2 * w (or +0), then the same update; barrier.
// The dense update is 16 bytes a slot each batch (4 MB at 2^18), too much
// for one cluster's SMs, so a launch in the dense regime is a cooperative
// grid of as many clusters as the card holds at once
// (cudaOccupancyMaxActiveClusters): cluster 0 runs the batches, the others
// wait at the grid barriers that take the place of barriers 2 and 3, and
// every block of the grid takes its share of the update.
//
// The state is one 16-byte record a slot, {w, g2, s, mark} (ws): a row's
// gather of w and s, and a slot's load and store, are one sector each (the
// wrapper packs the record from the learner's vectors before a launch and
// unpacks it after). Barriers are the cluster's (barrier.cluster, release
// / acquire): the state is read with ld.global.cg and written with
// st.global.cg, so no block reads an L1 line another block's store made
// stale. While batch j runs, each block's last warp copies batch j + 1's
// rows of idx, val, ebm, y and wt into the other of two shared buffers
// with cp.async.bulk (TMA),
// completing on an mbarrier (an unaligned head and tail of up to three
// words by plain loads), and asks the TMA unit to prefetch the block's
// share of batch j + 1's plan into L2 (cp.async.bulk.prefetch.L2).
//
// The cluster size is the caller's (vw/learner.py::V_CLUSTER_CTAS: 8
// blocks are portable, 16 need cudaFuncAttributeNonPortableClusterSizeAllowed).
// A launch that cannot be placed (too much shared memory, a cluster the
// card cannot hold) returns its CUDA error, which the wrapper raises:
// nothing falls back.
//
// Bound on the H100: bytes. A launch over batches [j0, j1) reads each
// batch's idx/val/y/wt once, and reads and writes once the 32-byte sectors
// of w, s and g2 that any of its batches' slots fall in (their union over
// the launch); in the dense regime w and g2 whole (16 bytes a slot). What
// is left is latency: a batch's dependent chains (the longest prediction,
// ~101 fmas; the commonest word's list, ~256 adds; the bias's levels), the
// two or three barriers, and the scattered gathers of the state (a sector a
// slot, through one cluster's L1s). With VW_CLOCKS set to 1 the kernel
// counts block 0's cycles a phase (tools/vw_step_bench.py --phases).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// the C entry point's argument (vw/learner.py::_VArgs mirrors it field for
// field); outside the anonymous namespace, so smt_vw_step keeps its linkage
struct VArgs {
  const int* idx;      // (j1 - j0, B, K) the batches' slots, batch j0 first
  const float* val;    // (j1 - j0, B, K)
  const float* y;      // (j1 - j0, B)
  const float* wt;     // (j1 - j0, B) importance weights (0 on padding rows)
  const float* ebm;    // the plan's (nb, B, K): each entry's slot's batch max |v|
  const int* ent;      // the plan's entries, list by list, row-major in a list
  const float* evals;  // the entries' values
  const int* useg;     // (U + 1,) starts of the slots' entries in ent
  const int* uslot;    // (U,) the slots
  const float* umax;   // (U,) the slots' batch max |v|
  const int* ulong;    // (nb,) each batch's first long list
  const int4* bounds;  // (nb,) each batch's slots [u0, u1) and entries [e0, e1)
  float4* ws;          // (dim,) a slot's state (w, g2, s, mark), mark's bits the
                       // dense regime's epoch that updated the slot
  float* bias;         // {b, bg2}
  float lr, l1, l2, lr_l1, q_hi, q_lo;
  int B, K, P, j0, j1, dim, loss, dense, ctas;
};

#ifndef VW_CLOCKS
#define VW_CLOCKS 0
#endif
// cycles of block 0's thread 0 a phase, summed over launches: rows and
// barrier 1; slots, the bias and barrier 2; the dense update and barrier 3
__device__ unsigned long long g_clocks[3];

namespace {

constexpr int kThreads = 512;  // 128 registers a thread (1,024 threads leave 64: spills)
constexpr int kWarps = kThreads / 32;
constexpr int kWaves = 4;                 // a warp's entries in flight: 4 x 32
constexpr int kChunk = 32 * kWaves;
constexpr int kPairs = kChunk + 2;        // a warp's (w, bvn) pairs, a neutral one, 16-byte rows
constexpr int kShortChunk = 8;            // a short list's loads in flight before its adds
constexpr int kMaxCtas = 32;              // a warp's lanes send a row's dl to every block
constexpr int kPortableCtas = 8;
constexpr int kSmemLimit = 232448;        // shared memory a block may ask for on the H100
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// The dynamic shared memory of a block, in bytes from its start:
//   [0, 16) two mbarriers; [16, 24) flags (two words, by batch parity);
//   [24, 32) the block's copy of {b, bg2}; dl (P floats); the bias tree
//   (P / 2 floats); each warp's pairs; with staging, two buffers of the
//   block's rows of idx, val, ebm, y and wt (a region each, 16 bytes of
//   slack for a source that starts off a 16-byte boundary).
struct Layout {
  int rpc, region, yregion, dl, tree, pairs, bufs, bytes;
};

constexpr int kStaged = 5;  // idx, val, ebm (rows x K words), y, wt (rows words)

// the byte offset of staged array q (0..4) of buffer `buf`
__host__ __device__ inline int region_at(const Layout& L, int buf, int q) {
  return L.bufs + buf * (3 * L.region + 2 * L.yregion) +
         (q < 3 ? q * L.region : 3 * L.region + (q - 3) * L.yregion);
}

__host__ __device__ inline Layout layout_of(int B, int K, int P, int ctas, bool stage) {
  Layout L;
  L.rpc = (B + ctas - 1) / ctas;
  L.region = align16(L.rpc * K * 4) + 16;
  L.yregion = align16(L.rpc * 4) + 16;
  L.dl = 32;
  L.tree = L.dl + align16(P * 4);
  L.pairs = L.tree + align16((P > 1 ? P / 2 : 1) * 4);
  L.bufs = L.pairs + kWarps * kPairs * 8;
  L.bytes = L.bufs + (stage ? 2 * (3 * L.region + 2 * L.yregion) : 0);
  return L;
}

// e^x, csrc/lambdarank.cu's exp_f32 (gbdt/lambdarank.py::exp_f32 op for op)
__device__ __forceinline__ float exp_f32(float x) {
  if (x > 88.f) return __int_as_float(0x7f800000);  // +inf
  const float xc = x < -20.f ? -20.f : x;
  const float k = rintf(__fmul_rn(xc, 1.44269502f));
  const float r = __fsub_rn(__fsub_rn(xc, __fmul_rn(k, 0.693145751953125f)),
                            __fmul_rn(k, 1.42860677e-06f));
  float p = 2.48015876e-05f;  // 1/8!
  p = __fadd_rn(__fmul_rn(p, r), 0.000198412701f);
  p = __fadd_rn(__fmul_rn(p, r), 0.00138888892f);
  p = __fadd_rn(__fmul_rn(p, r), 0.00833333377f);
  p = __fadd_rn(__fmul_rn(p, r), 0.0416666679f);
  p = __fadd_rn(__fmul_rn(p, r), 0.166666672f);
  p = __fadd_rn(__fmul_rn(p, r), 0.5f);
  p = __fadd_rn(__fmul_rn(p, r), 1.f);
  p = __fadd_rn(__fmul_rn(p, r), 1.f);
  return __fmul_rn(p, __int_as_float(((int)k + 127) << 23));
}

__device__ __forceinline__ float loss_grad(const VArgs& a, float p, float y, float wt) {
  switch (a.loss) {
    case 0:  // squared
      return __fmul_rn(__fsub_rn(p, y), wt);
    case 1:  // logistic
      return __fdiv_rn(__fmul_rn(-y, wt), __fadd_rn(1.f, exp_f32(__fmul_rn(y, p))));
    case 2:  // hinge
      return __fmul_rn(__fmul_rn(y, p) < 1.f ? -y : 0.f, wt);
    default:  // quantile
      return __fmul_rn(p >= y ? a.q_hi : a.q_lo, wt);
  }
}

__device__ __forceinline__ bool is_padding(int i, float v) {
  return i == 0 && __float_as_uint(v) == 0u;
}

// AdaGrad at gradient g, then the L1 shrink: the slot's new (w, g2)
__device__ __forceinline__ float2 step_slot(const VArgs& a, float w, float g2, float g) {
  const float g2n = __fmaf_rn(g, g, g2);
  const float root = __fsqrt_rn(g2n);
  float wn = __fsub_rn(w, __fdiv_rn(__fmul_rn(a.lr, g), root));
  if (a.l1 != 0.f) {
    float m = __fsub_rn(fabsf(wn), __fdiv_rn(a.lr_l1, root));
    m = (m > 0.f || m != m) ? m : 0.f;  // max(m, 0), NaN kept
    const float sg = wn > 0.f ? 1.f : (wn < 0.f ? -1.f : wn);  // sign: ±0, NaN kept
    wn = __fmul_rn(sg, m);
  }
  return make_float2(wn, g2n);
}

// with VW_CLOCKS: the cycles since `clk` to phase `phase`, then clk = now
__device__ __forceinline__ void tick(int phase, long long& clk) {
  if (VW_CLOCKS && blockIdx.x == 0 && threadIdx.x == 0) {
    const long long t = clock64();
    g_clocks[phase] += (unsigned long long)(t - clk);
    clk = t;
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from 16-byte aligned global `src` to 16-byte
// aligned shared `dst`, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(smem_addr(bar))
      : "memory");
}

// barrier.cluster in two halves: what a thread wrote before it arrives is
// seen by every thread of the cluster after its wait
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// words [begin, end) of `base` into L2: the 16-byte aligned part
__device__ __forceinline__ void prefetch_l2(const void* base, long long begin, long long end) {
  const uintptr_t lo = ((uintptr_t)base + 4 * begin + 15) & ~(uintptr_t)15;
  const uintptr_t hi = ((uintptr_t)base + 4 * end) & ~(uintptr_t)15;
  if (hi > lo)
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(lo),
                 "r"((uint32_t)(hi - lo))
                 : "memory");
}

// where word 0 of a source at `src` lands in a staging region
__device__ __forceinline__ int lead(const void* src) { return (int)(((uintptr_t)src & 15) >> 2); }

// Batch j's rows of block c into buffer `buf` (one warp): idx, val, ebm,
// each rows x K words contiguous, and y, wt, rows words; word e of an
// array lands at word
// lead(src) + e of its region, so the middle is 16-byte aligned on both
// sides and goes by one bulk copy, the head and tail (< 4 words each) by
// plain loads.
__device__ void stage_rows(const VArgs& a, const Layout& L, unsigned char* smem, uint64_t* bar,
                           int j, int buf, int c, int lane) {
  const int r0 = c * L.rpc;
  const int rows = max(0, min(a.B, r0 + L.rpc) - r0);
  const size_t off = ((size_t)(j - a.j0) * a.B + r0) * a.K;
  const size_t yoff = (size_t)(j - a.j0) * a.B + r0;
  const int* src[kStaged] = {a.idx + off, (const int*)a.val + off,
                             (const int*)a.ebm + ((size_t)j * a.B + r0) * a.K,
                             (const int*)a.y + yoff, (const int*)a.wt + yoff};
  uint32_t total = 0;
  int head[kStaged], mid[kStaged];
#pragma unroll
  for (int q = 0; q < kStaged; ++q) {
    const int n = q < 3 ? rows * a.K : rows;
    const int m = lead(src[q]);
    head[q] = m ? min(n, 4 - m) : 0;
    mid[q] = (n - head[q]) & ~3;
    const int tail = n - head[q] - mid[q];
    int* dst = (int*)(smem + region_at(L, buf, q)) + m;
    if (lane < head[q]) dst[lane] = src[q][lane];
    const int t = head[q] + mid[q] + lane - 4;  // the tail's word of this lane
    if (lane >= 4 && lane < 4 + tail) dst[t] = src[q][t];
    total += 4u * mid[q];
  }
  if (lane == 0) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(bar + buf, total);
#pragma unroll
    for (int q = 0; q < kStaged; ++q)
      if (mid[q] > 0) {
        int* dst = (int*)(smem + region_at(L, buf, q)) + lead(src[q]) + head[q];
        bulk_copy(dst, src[q] + head[q], 4u * mid[q], bar + buf);
      }
  }
}

// Block c's share of a batch's plan into L2: its slots [u0, u1) and their
// entries [e0, e1).
__device__ void prefetch_plan(const VArgs& a, int4 b, int c, int ctas) {
  const long long u0 = b.x, u1 = b.y, e0 = b.z, e1 = b.w;
  const long long ua = u0 + (u1 - u0) * c / ctas, ub = u0 + (u1 - u0) * (c + 1) / ctas;
  const long long ea = e0 + (e1 - e0) * c / ctas, eb = e0 + (e1 - e0) * (c + 1) / ctas;
  prefetch_l2(a.uslot, ua, ub);
  prefetch_l2(a.umax, ua, ub);
  prefetch_l2(a.useg, ua, ub + 1);
  prefetch_l2(a.ent, ea, eb);
  prefetch_l2(a.evals, ea, eb);
}

// Row r's prediction and loss gradient (one warp); `ri`, `rv`, `rm` its
// idx, val and ebm (staged or global). dl goes to every block's copy.
__device__ void row_step(const VArgs& a, const int* ri, const float* rv, const float* rm,
                         float yr, float wr, float b0, float2* pr, float* dl, int* flags,
                         int r, int lane) {
  const unsigned below = (1u << lane) - 1u;
  float acc = 0.f;
  bool padded = false;
  for (int k0 = 0; k0 < a.K; k0 += kChunk) {
    int iv[kWaves];
    float vv[kWaves], mv[kWaves], sv[kWaves], wv[kWaves];
    bool lv[kWaves];
#pragma unroll
    for (int t = 0; t < kWaves; ++t) {
      const int k = k0 + 32 * t + lane;
      const bool in = k < a.K;
      iv[t] = in ? ri[k] : 0;
      vv[t] = in ? rv[k] : 0.f;
      mv[t] = in ? rm[k] : 0.f;
      const bool pad = in && is_padding(iv[t], vv[t]);
      padded |= pad;
      lv[t] = in && !pad;
    }
#pragma unroll
    for (int t = 0; t < kWaves; ++t) {
      const float4 st = lv[t] ? __ldcg(a.ws + iv[t]) : make_float4(0.f, 0.f, 0.f, 0.f);
      sv[t] = st.z;
      wv[t] = st.x;
    }
    int n = 0;
#pragma unroll
    for (int t = 0; t < kWaves; ++t) {
      const unsigned live = __ballot_sync(kFull, lv[t]);
      if (lv[t]) {
        const float sn = fmaxf(sv[t], mv[t]);  // scales are finite: no NaN to keep
        pr[n + __popc(live & below)] = make_float2(wv[t], __fdiv_rn(vv[t], fmaxf(sn, 1e-12f)));
      }
      n += __popc(live);
    }
    if (lane == 0 && (n & 1)) pr[n] = make_float2(-0.f, 0.f);  // a neutral term
    __syncwarp();
    const float4* p4 = reinterpret_cast<const float4*>(pr);
#pragma unroll 4
    for (int q = 0; q < (n + 1) >> 1; ++q) {
      const float4 x = p4[q];
      acc = __fmaf_rn(x.x, x.y, acc);
      acc = __fmaf_rn(x.z, x.w, acc);
    }
    __syncwarp();
  }
  padded = __any_sync(kFull, padded);
  if (padded) acc = __fmaf_rn(__ldcg(&a.ws->x), 0.f, acc);
  const float d = loss_grad(a, __fadd_rn(acc, b0), yr, wr);
  if (lane < a.ctas) *cg::this_cluster().map_shared_rank(dl + r, lane) = d;
  if (padded && lane == 0) {
    const float z = __fmul_rn(d, 0.f);
    const int f = z != z ? 1 : (signbit(z) ? 0 : 2);
    if (f) atomicOr(cg::this_cluster().map_shared_rank(flags, 0), f);  // block 0's word
  }
}

// A slot list's plan and the slot's state: nothing of it depends on the
// batch's rows, so it is loaded while the cluster barrier after the rows
// completes.
struct SlotHead {
  int slot, e0, e1;
  float um;
  float4 st;  // {w, g2, s, mark}
};

__device__ __forceinline__ SlotHead slot_head(const VArgs& a, int u) {
  SlotHead h;
  h.slot = __ldg(a.uslot + u);
  h.um = __ldg(a.umax + u);
  h.e0 = __ldg(a.useg + u);
  h.e1 = __ldg(a.useg + u + 1);
  h.st = __ldcg(a.ws + h.slot);
  return h;
}

// p / K for a place p of a batch: below 2^24 (exact in f32) a float
// product, corrected by one either way, not an integer division
__device__ __forceinline__ int row_of(int p, int K, float inv_k) {
  if (p >= (1 << 24)) return p / K;
  int r = __float2int_rz(__int2float_rn(p) * inv_k);
  r -= r * K > p;
  r += (r + 1) * K <= p;
  return r;
}

// An entry's term dl[r] * (v / den); -0 (no effect) for the stand-in
__device__ __forceinline__ float term_of(const VArgs& a, const float* dl, int p, float v,
                                         float den, float inv_k) {
  return p >= 0 ? __fmul_rn(dl[row_of(p, a.K, inv_k)], __fdiv_rn(v, den)) : -0.f;
}

// The slot's padding term (slot 0 only), then its new s, w, g2 (and mark).
__device__ void finish_slot(const VArgs& a, const SlotHead& h, float sn, float g, int* flags,
                            int epoch) {
  if (h.slot == 0) {
    const int fl = *cg::this_cluster().map_shared_rank(flags, 0);
    if (fl & 1)
      g = __fadd_rn(g, __int_as_float(0x7fc00000));  // a NaN term
    else if (fl & 2)
      g = __fadd_rn(g, 0.f);  // a +0 term
  }
  const float2 wg = step_slot(a, h.st.x, h.st.y, g);
  __stcg(a.ws + h.slot, make_float4(wg.x, wg.y, sn, a.dense ? __int_as_float(epoch) : h.st.w));
}

// A short list, one thread: its terms eight at a time, added in order.
__device__ void short_list(const VArgs& a, const SlotHead& h, const float* dl, int* flags,
                           int epoch, float inv_k) {
  const float sn = fmaxf(h.st.z, h.um);
  const float den = fmaxf(sn, 1e-12f);
  float g = (a.dense && a.l2 != 0.f) ? __fmul_rn(a.l2, h.st.x) : 0.f;
  for (int e = h.e0; e < h.e1; e += kShortChunk) {
    const int n = min(kShortChunk, h.e1 - e);
    int p[kShortChunk];
    float v[kShortChunk];
#pragma unroll
    for (int q = 0; q < kShortChunk; ++q)
      if (q < n) {
        p[q] = __ldg(a.ent + e + q);
        v[q] = __ldg(a.evals + e + q);
      }
#pragma unroll
    for (int q = 0; q < kShortChunk; ++q)
      if (q < n) g = __fadd_rn(g, term_of(a, dl, p[q], v[q], den, inv_k));
  }
  finish_slot(a, h, sn, g, flags, epoch);
}

// A long list, one warp: 128 terms at once into shared memory, then every
// lane adds them in order; lane 0 writes the slot.
__device__ void long_list(const VArgs& a, const SlotHead& h, const float* dl, float* terms,
                          int* flags, int epoch, int lane, float inv_k) {
  const float sn = fmaxf(h.st.z, h.um);
  const float den = fmaxf(sn, 1e-12f);
  float g = (a.dense && a.l2 != 0.f) ? __fmul_rn(a.l2, h.st.x) : 0.f;
  for (int base = h.e0; base < h.e1; base += kChunk) {
    const int n = min(h.e1 - base, kChunk);
    int p[kWaves];
    float v[kWaves];
#pragma unroll
    for (int t = 0; t < kWaves; ++t) {
      const bool in = 32 * t + lane < n;
      p[t] = in ? __ldg(a.ent + base + 32 * t + lane) : -1;
      v[t] = in ? __ldg(a.evals + base + 32 * t + lane) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < kWaves; ++t)
      if (32 * t < n) terms[32 * t + lane] = term_of(a, dl, p[t], v[t], den, inv_k);
    __syncwarp();
    const float4* t4 = reinterpret_cast<const float4*>(terms);
#pragma unroll 4
    for (int q = 0; q < (n + 3) >> 2; ++q) {
      const float4 x = t4[q];
      g = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(g, x.x), x.y), x.z), x.w);
    }
    __syncwarp();
  }
  if (lane == 0) finish_slot(a, h, sn, g, flags, epoch);
}

// The bias step on the block's copy (one warp): dl summed pairwise, then
// AdaGrad. Levels down to 32 sums in place in `tree` (index i * st holds the
// sum of dl[2 * i * st, 2 * (i + 1) * st)), the last five by shuffles.
__device__ void bias_step(const VArgs& a, const float* dl, float* tree, float* bias, int lane) {
  float v;
  if (a.P <= 32) {
    v = lane < a.P ? dl[lane] : 0.f;
    for (int o = 1; o < a.P; o <<= 1) v = __fadd_rn(v, __shfl_down_sync(kFull, v, o));
  } else {
    for (int i = lane; i < a.P / 2; i += 32) tree[i] = __fadd_rn(dl[2 * i], dl[2 * i + 1]);
    int st = 1;
    for (int n = a.P / 2; n > 32; n >>= 1) {
      __syncwarp();
      st <<= 1;
      for (int i = lane; i < n / 2; i += 32)
        tree[i * st] = __fadd_rn(tree[i * st], tree[i * st + st / 2]);
    }
    __syncwarp();
    v = tree[lane * st];
    for (int o = 1; o < 32; o <<= 1) v = __fadd_rn(v, __shfl_down_sync(kFull, v, o));
  }
  if (lane == 0) {
    const float gb = __fdiv_rn(v, (float)a.B);
    const float bg2n = __fmaf_rn(gb, gb, bias[1]);
    bias[0] = __fsub_rn(bias[0], __fdiv_rn(__fmul_rn(a.lr, gb), __fsqrt_rn(bg2n)));
    bias[1] = bg2n;
  }
}

// The dense regime's update of every slot not marked with `epoch`: a
// slot's record a thread, two records in flight.
__device__ void dense_step(const VArgs& a, int gt, int nt, int epoch) {
  for (int q0 = gt; q0 < a.dim; q0 += 2 * nt) {
    float4 st[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (q0 + h * nt < a.dim) st[h] = __ldcg(a.ws + q0 + h * nt);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + h * nt;
      if (q >= a.dim || __float_as_int(st[h].w) == epoch) continue;
      const float2 wg =
          step_slot(a, st[h].x, st[h].y, a.l2 != 0.f ? __fmul_rn(a.l2, st[h].x) : 0.f);
      st[h].x = wg.x;
      st[h].y = wg.y;
      __stcg(a.ws + q, st[h]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) vw_pass_kernel(const VArgs a, const int stage) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int c = (int)cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Layout L = layout_of(a.B, a.K, a.P, a.ctas, stage);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* flags = reinterpret_cast<int*>(smem + 16);
  float* bias = reinterpret_cast<float*>(smem + 24);
  float* dl = reinterpret_cast<float*>(smem + L.dl);
  float* tree = reinterpret_cast<float*>(smem + L.tree);
  float2* pr = reinterpret_cast<float2*>(smem + L.pairs) + warp * kPairs;
  const int nt = a.ctas * kThreads, nw = a.ctas * kWarps;
  const int gt = c * kThreads + tid, gw = c * kWarps + warp;
  const int cl = blockIdx.x / a.ctas;  // this block's cluster: 0 runs the batches
  const int r0 = c * L.rpc;
  const int rows = cl == 0 ? max(0, min(a.B, r0 + L.rpc) - r0) : 0;
  const size_t bk = (size_t)a.B * a.K;

  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    flags[0] = flags[1] = 0;
    bias[0] = a.bias[0];
    bias[1] = a.bias[1];
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = a.B + tid; i < a.P; i += kThreads) dl[i] = 0.f;
  __syncthreads();
  if (stage && cl == 0 && warp == kWarps - 1) stage_rows(a, L, smem, bar, a.j0, 0, c, lane);
  cluster.sync();  // every block has started: its shared memory may be written
  if (cl != 0) {  // a helper cluster: each batch's dense update, between grid barriers
    for (int jj = 0; jj < a.j1 - a.j0; ++jj) {
      cg::this_grid().sync();
      dense_step(a, blockIdx.x * kThreads + tid, gridDim.x * kThreads, jj);
      cg::this_grid().sync();
    }
    return;
  }

  const float inv_k = 1.f / a.K;
  long long clk = VW_CLOCKS ? clock64() : 0;
  for (int j = a.j0; j < a.j1; ++j) {
    const int jj = j - a.j0, buf = jj & 1, epoch = jj;
    if (tid == 0) flags[buf ^ 1] = 0;  // the next batch's: last read in the previous batch
    const bool ahead = warp == kWarps - 1 && j + 1 < a.j1;  // the next batch's staging
    if (ahead && stage) stage_rows(a, L, smem, bar, j + 1, buf ^ 1, c, lane);

    // 1. rows
    if (warp < rows) {
      const float b0 = bias[0];
      if (stage) mbar_wait(bar + buf, (jj >> 1) & 1);
      const int* gidx = a.idx + jj * bk + (size_t)r0 * a.K;
      const float* gval = a.val + jj * bk + (size_t)r0 * a.K;
      const float* gebm = a.ebm + j * bk + (size_t)r0 * a.K;
      const float* gy = a.y + (size_t)jj * a.B + r0;
      const float* gwt = a.wt + (size_t)jj * a.B + r0;
      if (stage) {  // the same rows, staged
        gidx = (const int*)(smem + region_at(L, buf, 0)) + lead(gidx);
        gval = (const float*)(smem + region_at(L, buf, 1)) + lead(gval);
        gebm = (const float*)(smem + region_at(L, buf, 2)) + lead(gebm);
        gy = (const float*)(smem + region_at(L, buf, 3)) + lead(gy);
        gwt = (const float*)(smem + region_at(L, buf, 4)) + lead(gwt);
      }
      for (int rl = warp; rl < rows; rl += kWarps) {
        const size_t at = (size_t)rl * a.K;
        row_step(a, gidx + at, gval + at, gebm + at, gy[rl], gwt[rl], b0, pr, dl, flags + buf,
                 r0 + rl, lane);
      }
    }
    cluster_arrive();

    // 2. slots and the bias. The first long list of this warp and short
    // list of this thread, which the rows did not touch, load while the
    // barrier completes.
    const int4 bj = __ldg(a.bounds + j);
    const int ua = bj.x, ub = bj.y, ul = __ldg(a.ulong + j);
    const int nlong = ub - ul, nshort = ul - ua;
    const int busy = min(nlong, nw) * 32;  // threads of warps that took a long list
    const int q0 = (gt - busy + nt) % nt;
    SlotHead hl, hs;
    if (gw < nlong) hl = slot_head(a, ul + gw);
    if (q0 < nshort) hs = slot_head(a, ua + q0);
    cluster_wait();
    tick(0, clk);
    if (warp == kWarps - 1) {  // the bias, then the next batch's plan into L2
      const int4 next = ahead && lane == 0 ? __ldg(a.bounds + j + 1) : bj;
      bias_step(a, dl, tree, bias, lane);
      if (ahead && lane == 0) prefetch_plan(a, next, c, a.ctas);
    }
    for (int q = gw; q < nlong; q += nw)
      long_list(a, q == gw ? hl : slot_head(a, ul + q), dl, reinterpret_cast<float*>(pr),
                flags + buf, epoch, lane, inv_k);
    for (int q = q0; q < nshort; q += nt)
      short_list(a, q == q0 ? hs : slot_head(a, ua + q), dl, flags + buf, epoch, inv_k);

    // 3. the dense regime's untouched slots, over the grid (a grid barrier
    // orders all that a cluster barrier does)
    if (a.dense) {
      cg::this_grid().sync();
      tick(1, clk);
      dense_step(a, blockIdx.x * kThreads + tid, gridDim.x * kThreads, epoch);
      cg::this_grid().sync();
      tick(2, clk);
    } else {
      cluster.sync();
      tick(1, clk);
    }
  }
  if (c == 0 && tid == 0) {
    a.bias[0] = bias[0];
    a.bias[1] = bias[1];
  }
}

}  // namespace

extern "C" int smt_vw_step(const VArgs* a, void* stream) {
  if (a->B < 1 || a->K < 1 || a->P < a->B || a->j0 < 0 || a->j1 <= a->j0 || a->dim < 1 ||
      a->ctas < 1 || a->ctas > kMaxCtas)
    return (int)cudaErrorInvalidValue;
  const Layout staged = layout_of(a->B, a->K, a->P, a->ctas, true);
  const int stage = staged.bytes <= kSmemLimit;
  const Layout L = stage ? staged : layout_of(a->B, a->K, a->P, a->ctas, false);
  cudaError_t err = cudaFuncSetAttribute(vw_pass_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err == cudaSuccess && a->ctas > kPortableCtas)
    err = cudaFuncSetAttribute(vw_pass_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a->ctas);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a->ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (err == cudaSuccess && a->dense) {  // every cluster resident at once: a cooperative grid
    int clusters = 1;
    err = cudaOccupancyMaxActiveClusters(&clusters, vw_pass_kernel, &cfg);
    cfg.gridDim = dim3(a->ctas * (clusters > 1 ? clusters : 1));
    attr[1].id = cudaLaunchAttributeCooperative;
    attr[1].val.cooperative = 1;
    cfg.numAttrs = 2;
  }
  if (err == cudaSuccess) err = cudaLaunchKernelEx(&cfg, vw_pass_kernel, *a, stage);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no sticky error behind
    return (int)err;
  }
  return (int)cudaGetLastError();
}

// g_clocks into out[0..3), then zeroed (all 0 unless built with VW_CLOCKS=1)
extern "C" int smt_vw_clocks(unsigned long long* out) {
  const unsigned long long zero[3] = {0, 0, 0};
  cudaError_t err = cudaMemcpyFromSymbol(out, g_clocks, sizeof(g_clocks));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_clocks, zero, sizeof(g_clocks));
  return (int)err;
}

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
