// Kernel V: one minibatch step of the VW linear learner (AdaGrad, VW's
// --normalized scales, L1/L2), in place on the learner's state.
//
// Replaces: synapseml_tpu/vw/learner.py::train_linear -> batch_step
// (:130-153), which XLA runs once a batch inside lax.scan (:156): a scatter
// max of |v| into the scales, the normalised prediction, the loss gradient,
// a scatter-add of the entries' gradients into a dense 2^b vector, AdaGrad
// over all 2^b slots, the bias step.
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
// slot moves: the third kernel below updates the slots the batch did not
// touch.
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
//   - in slot 0's gradient each padding entry of row r adds dl_r * (+0)
//     (bvn of value 0 is +0: s is finite). A zero term changes a sum only
//     where the sum is zero: -0 (a sum started at l2 * w[0] = -0, all terms
//     -0) becomes +0 with one +0 term, and a NaN term (dl_r not finite)
//     makes it NaN. Which of those happens does not depend on where the
//     terms fall among the real ones. The rows kernel ORs into `flags`
//     (integer atomics, so the order does not matter) bit 0 for a NaN term
//     and bit 1 for a +0 term; slot 0's thread adds one term with that
//     effect after its real entries and clears the flags.
// So slot 0 takes no atomics and no serial walk over its padding.
//
// Order and plan. No float atomics: each slot's sum is one thread's, in
// row-major order. The fit's plan (vw/learner.py::StepPlan, built once on
// the card: the batches are the same every pass) lists each batch's
// distinct slots (uslot), each slot's entries in row-major order
// (ent[useg[u]..useg[u+1]), place r * K + k within the batch, -1 for a
// stand-in that only puts slot 0 in the list), each slot's batch max |v|
// (umax) and, per entry, its slot's umax (ebm), so the rows kernel computes
// the new scale of every entry without waiting for a scatter.
//
// One launch (one call of smt_vw_step, one count of VW_KERNEL) a batch is
// two or three device kernels on the stream:
//   1. rows: a thread a row (P threads; rows past B write dl = 0): the new
//      scales, the prediction, dl, the padding flags;
//   2. slots: a thread a distinct slot: its gradient, scale, g2 and w (and
//      in the dense regime its mark, the step's epoch); one more block, the
//      last, sums dl pairwise (in place on `tree`, a level a barrier: a
//      level-L sum writes index i * 2^L from i * 2^L and i * 2^L + 2^(L-1))
//      and steps the bias;
//   3. dense regime only: a thread a slot of all 2^b, skipping the slots
//      marked with this epoch: g = l2 * w (or +0), then the same update.
//
// Bound on the H100: bytes. A batch reads its idx/val/y/wt once and the
// 32-byte sectors of w, s and g2 that its slots fall in, and writes those
// sectors; the dense regime adds 16 bytes a slot (w, g2 read and written).
// At 256 reviews of the hashed-text shape that is about 0.3 MB (sparse) or
// 4.5 MB at 2^18 slots (dense): 0.1 us and 1.3 us at 3.35 TB/s. The
// kernel's time is launch and latency bound: three dependent kernels, the
// longest slot list (a common word: one entry a row, 256 dependent adds)
// and the bias's log2(P) barriers. A persistent design over the batches is
// later work (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

// the C entry point's argument (vw/learner.py::_VArgs mirrors it field for
// field); outside the anonymous namespace, so smt_vw_step keeps its linkage
struct VArgs {
  const int* idx;      // (B, K) this batch's slots
  const float* val;    // (B, K)
  const float* y;      // (B,)
  const float* wt;     // (B,) importance weights (0 on padding rows)
  const float* ebm;    // (B, K) each entry's slot's batch max |v| (0 on padding)
  const int* ent;      // the fit's plan: entries sorted by (batch, slot)
  const int* useg;     // (U + 1,) starts of the slots' entries in ent
  const int* uslot;    // (U,) the slots
  const float* umax;   // (U,) the slots' batch max |v|
  float* w;            // (dim,) normalised weights
  float* g2;           // (dim,)
  float* bias;         // {b, bg2}
  float* s;            // (dim,) scales
  float* dl;           // (P,) scratch: the rows' loss gradients
  float* tree;         // (P,) scratch: the bias sum
  int* flags;          // (1,) bit 0: a padding term is NaN; bit 1: one is +0
  int* mark;           // (dim,) dense regime: the epoch that updated a slot
  float lr, l1, l2, lr_l1, q_hi, q_lo;
  int B, K, P, u0, u1, dim, loss, dense, epoch;
};

namespace {

constexpr int kThreads = 128;

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

// g -> the slot's g2, w (AdaGrad, then the L1 shrink)
__device__ __forceinline__ void update_slot(const VArgs& a, int slot, float g) {
  const float g2n = __fmaf_rn(g, g, a.g2[slot]);
  const float root = __fsqrt_rn(g2n);
  float wn = __fsub_rn(a.w[slot], __fdiv_rn(__fmul_rn(a.lr, g), root));
  if (a.l1 != 0.f) {
    float m = __fsub_rn(fabsf(wn), __fdiv_rn(a.lr_l1, root));
    m = (m > 0.f || m != m) ? m : 0.f;  // max(m, 0), NaN kept
    const float sg = wn > 0.f ? 1.f : (wn < 0.f ? -1.f : wn);  // sign: ±0, NaN kept
    wn = __fmul_rn(sg, m);
  }
  a.g2[slot] = g2n;
  a.w[slot] = wn;
}

__global__ void __launch_bounds__(kThreads) vw_rows_kernel(const VArgs a) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= a.P) return;
  if (r >= a.B) {
    a.dl[r] = 0.f;
    return;
  }
  const int* ri = a.idx + (size_t)r * a.K;
  const float* rv = a.val + (size_t)r * a.K;
  const float* rm = a.ebm + (size_t)r * a.K;
  float acc = 0.f;
  bool padded = false;
  constexpr int kChunk = 8;  // gathers in flight before their ordered fmas
  for (int k0 = 0; k0 < a.K; k0 += kChunk) {
    float wk[kChunk], bk[kChunk];
    bool live[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int k = k0 + c;
      live[c] = false;
      if (k < a.K) {
        const int i = ri[k];
        const float v = rv[k];
        if (is_padding(i, v)) {
          padded = true;
        } else {
          const float sn = fmaxf(a.s[i], rm[k]);  // scales are finite: no NaN to keep
          bk[c] = __fdiv_rn(v, fmaxf(sn, 1e-12f));
          wk[c] = a.w[i];
          live[c] = true;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c)
      if (live[c]) acc = __fmaf_rn(wk[c], bk[c], acc);
  }
  if (padded) acc = __fmaf_rn(a.w[0], 0.f, acc);
  const float pred = __fadd_rn(acc, a.bias[0]);
  const float d = loss_grad(a, pred, a.y[r], a.wt[r]);
  a.dl[r] = d;
  if (padded) {
    const float z = __fmul_rn(d, 0.f);
    if (z != z)
      atomicOr(a.flags, 1);
    else if (!signbit(z))
      atomicOr(a.flags, 2);
  }
}

__global__ void __launch_bounds__(kThreads) vw_slots_kernel(const VArgs a) {
  if (blockIdx.x == gridDim.x - 1) {
    // the bias: dl summed pairwise (neighbours at each level), in place on tree
    for (int i = threadIdx.x; 2 * i + 1 < a.P; i += kThreads)
      a.tree[2 * i] = __fadd_rn(a.dl[2 * i], a.dl[2 * i + 1]);
    __syncthreads();
    for (int step = 4; step <= a.P; step <<= 1) {
      for (int i = threadIdx.x; i * step < a.P; i += kThreads)
        a.tree[i * step] = __fadd_rn(a.tree[i * step], a.tree[i * step + step / 2]);
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      const float sum = a.P > 1 ? a.tree[0] : a.dl[0];
      const float gb = __fdiv_rn(sum, (float)a.B);
      const float bg2n = __fmaf_rn(gb, gb, a.bias[1]);
      a.bias[0] = __fsub_rn(a.bias[0], __fdiv_rn(__fmul_rn(a.lr, gb), __fsqrt_rn(bg2n)));
      a.bias[1] = bg2n;
    }
    return;
  }
  const int u = a.u0 + blockIdx.x * kThreads + threadIdx.x;
  if (u >= a.u1) return;
  const int slot = a.uslot[u];
  const float sn = fmaxf(a.s[slot], a.umax[u]);
  const float den = fmaxf(sn, 1e-12f);
  float g = (a.dense && a.l2 != 0.f) ? __fmul_rn(a.l2, a.w[slot]) : 0.f;
  const int e1 = a.useg[u + 1];
  constexpr int kChunk = 8;  // entries' loads in flight before their ordered adds
  for (int e0 = a.useg[u]; e0 < e1; e0 += kChunk) {
    float ck[kChunk];
    bool live[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const int e = e0 + c;
      live[c] = false;
      if (e < e1) {
        const int p = a.ent[e];
        if (p >= 0) {
          ck[c] = __fmul_rn(a.dl[p / a.K], __fdiv_rn(a.val[p], den));
          live[c] = true;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kChunk; ++c)
      if (live[c]) g = __fadd_rn(g, ck[c]);
  }
  if (slot == 0) {
    const int fl = *a.flags;
    if (fl & 1)
      g = __fadd_rn(g, __int_as_float(0x7fc00000));  // a NaN term
    else if (fl & 2)
      g = __fadd_rn(g, 0.f);  // a +0 term
    *a.flags = 0;
  }
  a.s[slot] = sn;
  update_slot(a, slot, g);
  if (a.dense) a.mark[slot] = a.epoch;
}

__global__ void __launch_bounds__(kThreads) vw_dense_kernel(const VArgs a) {
  for (int j = blockIdx.x * kThreads + threadIdx.x; j < a.dim; j += gridDim.x * kThreads) {
    if (a.mark[j] == a.epoch) continue;
    const float g = a.l2 != 0.f ? __fmul_rn(a.l2, a.w[j]) : 0.f;
    update_slot(a, j, g);
  }
}

}  // namespace

extern "C" int smt_vw_step(const VArgs* a, void* stream) {
  if (a->B < 1 || a->K < 1 || a->P < a->B || a->u1 < a->u0 || a->dim < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  vw_rows_kernel<<<(a->P + kThreads - 1) / kThreads, kThreads, 0, s>>>(*a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int slot_blocks = (a->u1 - a->u0 + kThreads - 1) / kThreads;
  vw_slots_kernel<<<slot_blocks + 1, kThreads, 0, s>>>(*a);
  err = cudaGetLastError();
  if (err != cudaSuccess || !a->dense) return (int)err;
  const long long blocks = ((long long)a->dim + kThreads - 1) / kThreads;
  vw_dense_kernel<<<(int)(blocks < 4096 ? blocks : 4096), kThreads, 0, s>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
