// Kernel R: the time steps of the ONNX LSTM and GRU recurrence.
//
// Replaces: the lax.scan step of synapseml_tpu/onnx/ops.py::_lstm
// (:1131-1140) and ::_gru (:1156-1166). The input projection
// gx = x W^T + b has no step dependence and stays a torch.matmul outside, as
// the reference keeps it outside the scan (:1129, :1154). What is sequential
// is, per step t, h_{t-1} R^T fused with the gate math:
//   LSTM (gate order i, o, f, c): z = gx_t + h R^T; i = f(clip(z_i + p_i c));
//     f' = f(clip(z_f + p_f c)); c' = f' c + i g(clip(z_c));
//     o = f(clip(z_o + p_o c')); h' = o h_act(c').
//   GRU (gate order z, r, h): z = f(clip(x_z + h R_z^T + rb_z)), r likewise;
//     linear_before_reset=1: h~ = g(clip(x_h + r (h R_h^T + rb_h)));
//     linear_before_reset=0: h~ = g(clip(x_h + (r h) R_h^T + rb_h));
//     h' = (1 - z) h~ + z h.
// f, g, h_act are Sigmoid, Tanh or Relu, as the node's activations say.
//
// Two entries, picked by the wrapper from the shape before a launch (never
// on a failed one; onnx/rnn.py::rnn_plan mirrors p_layout below):
//
// smt_rnn_persistent (the main one): ONE cooperative launch a call. The grid
// is ceil(H / J) blocks of 256 threads, at most one a streaming
// multiprocessor, all resident at once; block x owns hidden units
// [x J, x J + J) of every gate, and its G J rows of R stay in shared memory
// for all S steps (at GNMT's width, H = 1,024 in f32: 128 blocks, J = 8,
// 128 KB of R a block; a thread-block cluster's 16 SMs could not hold R's
// 16 MB, so the grid spans the card). A grid barrier takes the place of a
// launch: each step a block computes its units' gates for all B rows and
// writes its slice of h_t to Y[t]; after cg::this_grid().sync() every block
// streams h_t from L2 (cp.async.cg, k-tiles of 64 batch rows in three
// buffers: B x H f32 does not fit beside R). GRU with linear_before_reset=0
// takes two barriers a step: its second product needs r h of every unit,
// which phase A writes to a scratch (B, H) in device memory.
//   The product of a tile: the 8 warps split the tile's k, each computes
//   all 64 x NR outputs (the block's G J rows, padded to NR, a multiple of
//   8 up to 32, with a zero row), and the gate math sums the 8 partials
//   from shared memory. f32: FMAs on the CUDA cores, an 8 x NR / 4
//   register tile a thread (lanes 8 rows x 4 columns), float4 loads from
//   shared memory, so f32 stays within 1e-5 of
//   the plain step and the bound is the f32 rate. bf16: mma.sync m16n8k16
//   on the tensor cores (h the A operand, R's rows the B operand), f32
//   accumulation. The cell state (LSTM) or the unit's own h (GRU) stays in
//   shared memory across steps.
// smt_rnn_steps (the fallback, for shapes whose R rows do not fit a block's
// shared memory, whose units a block would exceed 32 rows, or whose H is
// not a multiple of 8): one launch a step (two for GRU with
// linear_before_reset=0: the first launch writes z and r h, the second the
// new state), all S steps launched from one C call on one stream. Its bound
// at the widths it serves (an LSTM at H = 2,048 f32: R is 64 MB, past the
// card's shared memory and its 50 MB L2) is the step's FMAs, 2 B G H^2 at
// the f32 rate, with R streamed from device memory every step. Its design:
// - a block owns 16 hidden units, all G of their gates (64 rows of R for an
//   LSTM), and 64 batch rows (a grid of ceil(H / 16) x ceil(B / 64)), so
//   R is read once a step up to B = 64 (at H = 2,048: 128 blocks, under
//   one wave on 132 SMs);
// - k runs in tiles of 256 bytes a row (64 f32 / 128 bf16) through a ring of
//   kSStages stages in shared memory filled by cp.async (16-byte pieces,
//   zero-filled past B and H; where H is not a multiple of 16 bytes, plain
//   loads fill the same ring), so three tiles load while one is multiplied;
//   a row's stride is 272 bytes (distinct banks for 8 rows of 16 bytes);
//   256-byte pieces of each row of R read more of a DRAM page a visit than
//   128-byte ones did (5-7 % a call at H = 2,048);
// - f32: FMAs on the CUDA cores, k split four ways: warp pair p takes the
//   p-th quarter of every tile, a thread 8 batch rows (b, b + 8, ...) x 2
//   units x G gates, so 8 + 2 G 16-byte shared loads feed 64 G FMAs; the
//   four partial dots meet in shared memory (the ring, once drained) and
//   are summed in pair order. By instruction count a 16-byte shared load
//   takes four of the SM's cycles (128 bytes a cycle) whatever it
//   broadcasts, so at 8 x 8 a thread the loads need about as many cycles
//   as the FMAs; R's bytes (64 MB a step at H = 2,048) need 19 us at 3.35
//   TB/s, under the FMAs' 32 us. bf16: mma.sync m16n8k16 with f32 accumulation, a warp 16
//   batch rows x 8 units x G gates; a thread's accumulators hold G gates of
//   4 (row, unit) pairs;
// - every gate of a (row, unit) pair then lies in one thread's registers,
//   in the op order of the persistent entry. h_{t-1} is read from Y[t-1]
//   (Y[t] is h_t), the cell state is updated in place (only its own thread
//   reads it).
//
// f32 and bf16: in bf16 every operand is bf16 and the dots accumulate in f32;
// each op of the reference's step rounds to bf16 where the reference's op
// leaves bf16 (the dot, each add and product, each activation). In f32 the
// same ops, each rounded once (no contraction into FMAs outside the dot).
// Both entries do the gate math in the same op order.
//
// Bound on the H100: operations, 2 S B G H^2 at the f32 rate (f32) or the
// bf16 tensor-core rate (bf16), at GNMT's width (S=128, B=64, H=1024).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "occupancy.cuh"

namespace cg = cooperative_groups;

struct RArgs {
  const void* gx;  // (S, B, G*H): x W^T + wb (+ rb for the LSTM)
  const void* r;   // (G*H, H)
  const void* h0;  // (B, H)
  const void* p;   // LSTM peepholes (3H: p_i, p_o, p_f) or null (zeros)
  const void* rb;  // GRU recurrent bias (3H) or null (zeros)
  void* y;         // (S, B, H)
  void* c;         // LSTM cell state (B, H): c0 in, Y_c out
  void* z;         // GRU, linear_before_reset=0: z of the step (B, H)
  void* rh;        // GRU, linear_before_reset=0: r h of the step (B, H)
  float clip;
  int has_clip, S, B, H, kind, lbr, bf16, act_f, act_g, act_h, device;
  int units;       // the persistent entry: hidden units a block (J)
};

namespace {

enum { kLstm = 0, kGruLbr = 1, kGruA = 2, kGruB = 3 };

template <int MODE>
struct Gates {
  static constexpr int n = MODE == kLstm ? 4 : MODE == kGruLbr ? 3 : MODE == kGruA ? 2 : 1;
};

__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st_(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void st_(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// the value as the reference's op leaves it: rounded to bf16 in bf16
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (sizeof(T) == 2) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

template <typename T>
__device__ __forceinline__ float add(float x, float y) { return rnd<T>(__fadd_rn(x, y)); }
template <typename T>
__device__ __forceinline__ float mul(float x, float y) { return rnd<T>(__fmul_rn(x, y)); }

__device__ __forceinline__ float act(int kind, float v) {
  if (kind == 0) return 1.f / (1.f + expf(-v));
  if (kind == 1) return tanhf(v);
  return fmaxf(v, 0.f);
}

__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------ the one-launch-a-step entry ----

constexpr int kSB = 64;           // batch rows a block
constexpr int kSU = 16;           // hidden units a block
constexpr int kSThreads = 256;    // 8 warps
constexpr int kSStages = 4;       // k-tiles in the ring: one multiplied, three loading
constexpr int kSTile = 256;       // bytes of a row's k-tile: 64 f32 / 128 bf16
constexpr int kSLd = kSTile + 16; // a row's stride in shared memory (bytes)

// a stage: 64 rows of the product's left operand, then R's rows (gate q,
// unit u at row 64 + 16 q + u)
template <int G>
__host__ __device__ constexpr int s_stage_bytes() { return (kSB + G * kSU) * kSLd; }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// k-tile kt of the block's rows into `dst`, zero past B and H: cp.async in
// 16-byte pieces (VEC: H a multiple of 16 bytes, the rows 16-byte aligned),
// else plain loads
template <typename T, int G, bool VEC>
__device__ __forceinline__ void s_load(uint8_t* dst, const T* src, const T* R, int gate0, int B,
                                       int H, int b0, int j0, int kt) {
  constexpr int KT = kSTile / (int)sizeof(T), kRows = kSB + G * kSU;
  if constexpr (VEC) {
    constexpr int kChunks = kSTile / 16, kPer = 16 / (int)sizeof(T);
    const uint32_t d0 = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    for (int e = threadIdx.x; e < kRows * kChunks; e += kSThreads) {
      const int row = e / kChunks, ch = e % kChunks, k = kt * KT + ch * kPer;
      const T* p;
      bool ok;
      if (row < kSB) {
        const int b = b0 + row;
        ok = b < B && k < H;
        p = src + (long long)b * H + k;
      } else {
        const int q = (row - kSB) / kSU, u = j0 + (row - kSB) % kSU;
        ok = u < H && k < H;
        p = R + ((long long)(gate0 + q) * H + u) * H + k;
      }
      cp_async16_zfill(d0 + row * kSLd + ch * 16, ok ? p : src, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * KT; e += kSThreads) {
      const int row = e / KT, kk = e % KT, k = kt * KT + kk;
      T v = T(0.f);
      if (row < kSB) {
        const int b = b0 + row;
        if (b < B && k < H) v = src[(long long)b * H + k];
      } else {
        const int q = (row - kSB) / kSU, u = j0 + (row - kSB) % kSU;
        if (u < H && k < H) v = R[((long long)(gate0 + q) * H + u) * H + k];
      }
      reinterpret_cast<T*>(dst + row * kSLd)[kk] = v;
    }
  }
}

template <typename T, int MODE, bool VEC>
__global__ void __launch_bounds__(kSThreads) rnn_step_kernel(const RArgs a, int t) {
  constexpr int G = Gates<MODE>::n;
  constexpr bool bf = sizeof(T) == 2;
  constexpr int KT = kSTile / (int)sizeof(T), LD = kSLd / (int)sizeof(T);
  constexpr int kStage = s_stage_bytes<G>();
  extern __shared__ __align__(16) uint8_t ssm[];

  const int H = a.H, B = a.B;
  const long long BH = (long long)B * H;
  const T* y = static_cast<const T*>(a.y);
  // the product's left operand: h_{t-1}, or r h of this step (GRU part B)
  const T* src = MODE == kGruB ? static_cast<const T*>(a.rh)
                 : t == 0      ? static_cast<const T*>(a.h0)
                               : y + (t - 1) * BH;
  const T* hprev = t == 0 ? static_cast<const T*>(a.h0) : y + (t - 1) * BH;
  const T* R = static_cast<const T*>(a.r);
  // the gates of R this launch multiplies: LSTM i o f c; GRU z r (h); part A z r; part B h
  const int gate0 = MODE == kGruB ? 2 : 0;
  const int j0 = blockIdx.x * kSU, b0 = blockIdx.y * kSB;
  const int nkt = (H + KT - 1) / KT;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;

#pragma unroll
  for (int s = 0; s < kSStages - 1; ++s) {
    if (s < nkt) s_load<T, G, VEC>(ssm + s * kStage, src, R, gate0, B, H, b0, j0, s);
    if constexpr (VEC) cp_commit();
  }
  // wait for tile kt (the next kSStages - 2 may stay in flight), then start
  // tile kt + kSStages - 1 in the buffer every thread is done with
  auto next = [&](int kt) {
    if constexpr (VEC) cp_wait<kSStages - 2>();
    __syncthreads();
    const int nt = kt + kSStages - 1;
    if (nt < nkt)
      s_load<T, G, VEC>(ssm + (nt % kSStages) * kStage, src, R, gate0, B, H, b0, j0, nt);
    if constexpr (VEC) cp_commit();
  };

  // the dots of this thread's 4 (batch row, unit) pairs with every gate
  float dot[4][G];
  int prow[4], punit[4];
  if constexpr (!bf) {
    // split k: warp pair kg takes the kg-th quarter of every tile's k; a
    // thread's tile is 8 batch rows (tb + 8 i) x 2 units (tu, tu + 8) x G
    // gates, so 8 + 2 G 16-byte loads feed 64 G FMAs
    const int kg = w >> 1, t64 = threadIdx.x & 63, tb = t64 & 7, tu = t64 >> 3;
    float acc[8][2 * G];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int n = 0; n < 2 * G; ++n) acc[i][n] = 0.f;
    for (int kt = 0; kt < nkt; ++kt) {
      next(kt);
      const float* hs = reinterpret_cast<const float*>(ssm + (kt % kSStages) * kStage);
      const float* rs = hs + kSB * LD;
#pragma unroll
      for (int k4 = kg * (KT / 16); k4 < (kg + 1) * (KT / 16); ++k4) {
        float4 hv[8], rv[2 * G];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          hv[i] = *reinterpret_cast<const float4*>(hs + (tb + 8 * i) * LD + 4 * k4);
#pragma unroll
        for (int n = 0; n < 2 * G; ++n)   // n = 2 q + v: gate q, unit tu + 8 v
          rv[n] = *reinterpret_cast<const float4*>(
              rs + ((n >> 1) * kSU + tu + 8 * (n & 1)) * LD + 4 * k4);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int n = 0; n < 2 * G; ++n) {
            float s = acc[i][n];
            s = fmaf(hv[i].x, rv[n].x, s);
            s = fmaf(hv[i].y, rv[n].y, s);
            s = fmaf(hv[i].z, rv[n].z, s);
            acc[i][n] = fmaf(hv[i].w, rv[n].w, s);
          }
      }
    }
    // the four warp pairs' partial dots through shared memory (the ring is
    // free once every copy has landed), summed in warp-pair order
    constexpr int PW = G * kSU + 1;  // a batch row's partials, padded
    static_assert(4 * kSB * PW * 4 <= kSStages * kStage, "partials past the ring");
    float* part = reinterpret_cast<float*>(ssm);
    if constexpr (VEC) cp_wait<0>();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int n = 0; n < 2 * G; ++n)
        part[(kg * kSB + tb + 8 * i) * PW + (n >> 1) * kSU + tu + 8 * (n & 1)] = acc[i][n];
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pair = threadIdx.x + kSThreads * e;
      prow[e] = pair >> 4;
      punit[e] = pair & 15;
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const float* pp = part + prow[e] * PW + q * kSU + punit[e];
        dot[e][q] = ((pp[0] + pp[kSB * PW]) + pp[2 * kSB * PW]) + pp[3 * kSB * PW];
      }
    }
  } else {
    const int ug = w & 1, mt = w >> 1, g = lane >> 2, tq = lane & 3;
    float acc[G][4];
#pragma unroll
    for (int q = 0; q < G; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
    for (int kt = 0; kt < nkt; ++kt) {
      next(kt);
      const __nv_bfloat16* hs =
          reinterpret_cast<const __nv_bfloat16*>(ssm + (kt % kSStages) * kStage);
      const __nv_bfloat16* rs = hs + kSB * LD;
#pragma unroll
      for (int k16 = 0; k16 < KT / 16; ++k16) {
        const __nv_bfloat16* a0 = hs + (16 * mt + g) * LD + 16 * k16 + 2 * tq;
        uint32_t af[4];
        af[0] = *reinterpret_cast<const uint32_t*>(a0);
        af[1] = *reinterpret_cast<const uint32_t*>(a0 + 8 * LD);
        af[2] = *reinterpret_cast<const uint32_t*>(a0 + 8);
        af[3] = *reinterpret_cast<const uint32_t*>(a0 + 8 * LD + 8);
#pragma unroll
        for (int q = 0; q < G; ++q) {
          const __nv_bfloat16* b0p = rs + (q * kSU + 8 * ug + g) * LD + 16 * k16 + 2 * tq;
          mma_bf16(acc[q], af, *reinterpret_cast<const uint32_t*>(b0p),
                   *reinterpret_cast<const uint32_t*>(b0p + 8));
        }
      }
    }
    // accumulator e of an m16n8 tile: row g + 8 (e / 2), column 2 tq + e % 2
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      prow[e] = 16 * mt + g + 8 * (e >> 1);
      punit[e] = 8 * ug + 2 * tq + (e & 1);
#pragma unroll
      for (int q = 0; q < G; ++q) dot[e][q] = acc[q][e];
    }
  }

  const int gw = MODE == kLstm ? 4 : 3;   // gates a row of gx holds
  const T* gxt = static_cast<const T*>(a.gx) + (long long)t * B * gw * H;
  const float clip = rnd<T>(a.clip);
  auto squash = [&](float v) { return a.has_clip ? fminf(fmaxf(v, -clip), clip) : v; };
  auto f = [&](float v) { return rnd<T>(act(a.act_f, squash(v))); };
  auto g = [&](float v) { return rnd<T>(act(a.act_g, squash(v))); };
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int b = b0 + prow[p], jj = j0 + punit[p];
    if (b >= B || jj >= H) continue;
    const long long o = (long long)b * H + jj;
    const T* xg = gxt + (long long)b * gw * H;
    if constexpr (MODE == kLstm) {
      const T* P = static_cast<const T*>(a.p);
      T* C = static_cast<T*>(a.c);
      const float pi = P ? ld(P, jj) : 0.f, po = P ? ld(P, H + jj) : 0.f,
                  pf = P ? ld(P, 2 * H + jj) : 0.f;
      const float zi = add<T>(ld(xg, jj), rnd<T>(dot[p][0]));
      const float zo = add<T>(ld(xg, H + jj), rnd<T>(dot[p][1]));
      const float zf = add<T>(ld(xg, 2 * H + jj), rnd<T>(dot[p][2]));
      const float zc = add<T>(ld(xg, 3 * H + jj), rnd<T>(dot[p][3]));
      const float c = ld(C, o);
      const float gi = f(add<T>(zi, mul<T>(pi, c)));
      const float gf = f(add<T>(zf, mul<T>(pf, c)));
      const float cn = add<T>(mul<T>(gf, c), mul<T>(gi, g(zc)));
      const float go = f(add<T>(zo, mul<T>(po, cn)));
      st_(C, o, cn);
      st_(static_cast<T*>(a.y), t * BH + o, mul<T>(go, rnd<T>(act(a.act_h, cn))));
    } else {
      const T* RB = static_cast<const T*>(a.rb);
      const float rbz = RB ? ld(RB, jj) : 0.f, rbr = RB ? ld(RB, H + jj) : 0.f,
                  rbh = RB ? ld(RB, 2 * H + jj) : 0.f;
      const float h = ld(hprev, o);
      float z, hh;
      if constexpr (MODE == kGruLbr || MODE == kGruA) {
        z = f(add<T>(add<T>(ld(xg, jj), rnd<T>(dot[p][0])), rbz));
        const float r = f(add<T>(add<T>(ld(xg, H + jj), rnd<T>(dot[p][1])), rbr));
        if constexpr (MODE == kGruA) {
          st_(static_cast<T*>(a.z), o, z);
          st_(static_cast<T*>(a.rh), o, mul<T>(r, h));
          continue;
        } else {
          hh = g(add<T>(ld(xg, 2 * H + jj), mul<T>(r, add<T>(rnd<T>(dot[p][2]), rbh))));
        }
      } else {
        z = ld(static_cast<const T*>(a.z), o);
        hh = g(add<T>(add<T>(ld(xg, 2 * H + jj), rnd<T>(dot[p][0])), rbh));
      }
      st_(static_cast<T*>(a.y), t * BH + o,
         add<T>(mul<T>(rnd<T>(__fsub_rn(1.f, z)), hh), mul<T>(z, h)));
    }
  }
}

template <typename T, int MODE, bool VEC>
cudaError_t s_allow_smem() {
  constexpr int bytes = kSStages * s_stage_bytes<Gates<MODE>::n>();
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(rnn_step_kernel<T, MODE, VEC>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int MODE, bool VEC>
void s_launch(const RArgs& a, int t, dim3 grid, cudaStream_t stream) {
  rnn_step_kernel<T, MODE, VEC>
      <<<grid, kSThreads, kSStages * s_stage_bytes<Gates<MODE>::n>(), stream>>>(a, t);
}

template <typename T, bool VEC>
cudaError_t run_steps(const RArgs& a, cudaStream_t stream) {
  const dim3 grid((a.H + kSU - 1) / kSU, (a.B + kSB - 1) / kSB);
  cudaError_t err = a.kind == 0 ? s_allow_smem<T, kLstm, VEC>()
                    : a.lbr     ? s_allow_smem<T, kGruLbr, VEC>()
                                : s_allow_smem<T, kGruA, VEC>();
  if (err == cudaSuccess && a.kind != 0 && !a.lbr) err = s_allow_smem<T, kGruB, VEC>();
  if (err != cudaSuccess) return err;
  for (int t = 0; t < a.S; ++t) {
    if (a.kind == 0) {
      s_launch<T, kLstm, VEC>(a, t, grid, stream);
    } else if (a.lbr) {
      s_launch<T, kGruLbr, VEC>(a, t, grid, stream);
    } else {
      s_launch<T, kGruA, VEC>(a, t, grid, stream);
      s_launch<T, kGruB, VEC>(a, t, grid, stream);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

__host__ inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
cudaError_t run(const RArgs& a, cudaStream_t stream) {
  const bool vec = a.H % (16 / (int)sizeof(T)) == 0 && aligned16(a.r) && aligned16(a.h0) &&
                   aligned16(a.y) && aligned16(a.rh);
  return vec ? run_steps<T, true>(a, stream) : run_steps<T, false>(a, stream);
}


// ------------------------------------------------ the persistent entry ----

constexpr int kPB = 64;        // batch rows a chunk
constexpr int kPThreads = 256; // 8 warps
constexpr int kPRows = 32;     // the most rows of R a product covers
constexpr int kPartLd = kPRows + 4;
constexpr int kHBufs = 3;      // h tiles in flight: the one computed and two loading
// (row, unit) pairs a thread: 64 rows x J units over 256 threads (LSTM J <= 8,
// GRU J <= 10 with linear_before_reset=1, 16 with 0)
template <int KIND>
__host__ __device__ constexpr int p_pairs() { return KIND == 0 ? 2 : KIND == 1 ? 3 : 4; }
enum { kPLstm = 0, kPGru1 = 1, kPGru0 = 2 };

// k a tile and the h tile's row stride (elements): 64 f32 / 256 bf16 a tile,
// each row's stride 4 words past a multiple of 32 (distinct banks)
__host__ __device__ constexpr int p_kt(int bf16) { return bf16 ? 256 : 64; }
__host__ __device__ constexpr int p_ldh(int bf16) { return bf16 ? 264 : 68; }

struct PLayout {
  int ldr;              // R's row stride in shared memory (elements)
  int rows;             // R rows held: G J and a zero row
  long long work;       // offset of the h tiles / partial sums
  long long state;      // offset of the per-unit state (B x J f32; GRU lbr=0: two)
  long long bytes;      // the dynamic shared memory
};

// The shared-memory plan of a block owning J units (onnx/rnn.py::rnn_plan
// computes the same bytes).
__host__ __device__ inline PLayout p_layout(int kind, int lbr, int bf16, int B, int H, int J) {
  const int kt = p_kt(bf16), esz = bf16 ? 2 : 4;
  const int hp = (H + kt - 1) / kt * kt;
  PLayout L;
  // row stride 4 words past a multiple of 32
  L.ldr = bf16 ? hp + ((8 - hp) % 64 + 64) % 64 : hp + ((4 - hp) % 32 + 32) % 32;
  const int G = kind == 0 ? 4 : 3;
  L.rows = G * J + 1;
  const long long r_bytes = ((long long)L.rows * L.ldr * esz + 15) / 16 * 16;
  const long long part = 8LL * kPB * kPartLd * 4, hbuf = (long long)kHBufs * kPB * p_ldh(bf16) * esz;
  L.work = r_bytes;
  L.state = L.work + (part > hbuf ? part : hbuf);
  L.bytes = L.state + (long long)B * J * 4 * (kind == 1 && !lbr ? 2 : 1);
  return L;
}

// h tile kt (batch rows [b0, b0 + 64), k [kt KT, kt KT + KT)) of src (B x H)
// into `dst`, rows past B and k past H zero-filled
template <typename T>
__device__ __forceinline__ void load_h_tile(T* dst, const T* src, int B, int H, int b0, int kt) {
  constexpr int bf = sizeof(T) == 2, KT = p_kt(bf), LDH = p_ldh(bf);
  constexpr int kChunks = KT * (int)sizeof(T) / 16, kPer = 16 / (int)sizeof(T);
  const uint32_t d0 = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  for (int e = threadIdx.x; e < kPB * kChunks; e += kPThreads) {
    const int r = e / kChunks, ch = e % kChunks, b = b0 + r, k = kt * KT + ch * kPer;
    const bool ok = b < B && k < H;
    cp_async16_zfill(d0 + (r * LDH + ch * kPer) * (int)sizeof(T),
                     src + (ok ? (long long)b * H + k : 0), ok ? 16 : 0);
  }
  cp_commit();
}

// The partial products of batch rows [b0, b0 + 64) of src with the block's
// R rows [row0, row0 + nrows) (NR of them, a multiple of 8 >= nrows; rows
// past nrows read the zero row): warp w's share of every k-tile into
// part[w][row][n], then a block barrier. The h tiles pass through kHBufs
// buffers, two loading while one is computed.
template <typename T, int NR>
__device__ void product(const T* src, int B, int H, int b0, const T* Rs, const PLayout& L,
                        int row0, int nrows, T* hbuf, float* part) {
  constexpr int bf = sizeof(T) == 2, KT = p_kt(bf), LDH = p_ldh(bf);
  const int nkt = (H + KT - 1) / KT;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int zrow = (L.rows - 1) * L.ldr;
  load_h_tile(hbuf, src, B, H, b0, 0);
  if (nkt > 1) load_h_tile(hbuf + kPB * LDH, src, B, H, b0, 1);
  // wait for tile kt (tile kt + 1 may stay in flight), then start tile kt + 2
  auto next = [&](int kt) {
    if (kt + 1 < nkt) {
      cp_wait_one();
    } else {
      cp_wait_all();
    }
    __syncthreads();
    if (kt + 2 < nkt) load_h_tile(hbuf + ((kt + 2) % kHBufs) * kPB * LDH, src, B, H, b0, kt + 2);
  };
  if constexpr (!bf) {
    constexpr int JN = NR / 4;
    const int bl = lane & 7, nl = lane >> 3;
    int roff[JN];
#pragma unroll
    for (int jn = 0; jn < JN; ++jn) {
      const int n = nl + 4 * jn;
      roff[jn] = n < nrows ? (row0 + n) * L.ldr : zrow;
    }
    float acc[8][JN];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jn = 0; jn < JN; ++jn) acc[i][jn] = 0.f;
    for (int kt = 0; kt < nkt; ++kt) {
      next(kt);
      const float* hb = reinterpret_cast<const float*>(hbuf) + (kt % kHBufs) * kPB * LDH;
      const float* rk = reinterpret_cast<const float*>(Rs) + kt * KT;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int k = 8 * w + 4 * s;
        float4 hv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          hv[i] = *reinterpret_cast<const float4*>(hb + (bl + 8 * i) * LDH + k);
#pragma unroll
        for (int jn = 0; jn < JN; ++jn) {
          const float4 r = *reinterpret_cast<const float4*>(rk + roff[jn] + k);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            float a_ = acc[i][jn];
            a_ = fmaf(hv[i].x, r.x, a_);
            a_ = fmaf(hv[i].y, r.y, a_);
            a_ = fmaf(hv[i].z, r.z, a_);
            acc[i][jn] = fmaf(hv[i].w, r.w, a_);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the h tiles, which part overlays
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int jn = 0; jn < JN; ++jn)
        part[(w * kPB + bl + 8 * i) * kPartLd + nl + 4 * jn] = acc[i][jn];
  } else {
    constexpr int NT = NR / 8;
    const int g = lane >> 2, t = lane & 3;
    int roff[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = 8 * nt + g;
      roff[nt] = n < nrows ? (row0 + n) * L.ldr : zrow;
    }
    float acc[4][NT][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    for (int kt = 0; kt < nkt; ++kt) {
      next(kt);
      const __nv_bfloat16* hb =
          reinterpret_cast<const __nv_bfloat16*>(hbuf) + (kt % kHBufs) * kPB * LDH;
      const __nv_bfloat16* rk = reinterpret_cast<const __nv_bfloat16*>(Rs) + kt * KT;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int kk = 32 * w + 16 * s;
        uint32_t af[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const __nv_bfloat16* r0 = hb + (16 * mt + g) * LDH + kk + 2 * t;
          af[mt][0] = *reinterpret_cast<const uint32_t*>(r0);
          af[mt][1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * LDH);
          af[mt][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
          af[mt][3] = *reinterpret_cast<const uint32_t*>(r0 + 8 * LDH + 8);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const __nv_bfloat16* c0 = rk + roff[nt] + kk + 2 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(c0);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(c0 + 8);
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float* o = part + (w * kPB + 16 * mt + g) * kPartLd + 8 * nt + 2 * t;
        o[0] = acc[mt][nt][0];
        o[1] = acc[mt][nt][1];
        o[8 * kPartLd] = acc[mt][nt][2];
        o[8 * kPartLd + 1] = acc[mt][nt][3];
      }
  }
  __syncthreads();
}

// the product's column n of batch row bl: the 8 warps' partials, in warp order
__device__ __forceinline__ float dot_of(const float* part, int bl, int n) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < 8; ++w) s += part[(w * kPB + bl) * kPartLd + n];
  return s;
}

// KIND: LSTM, GRU (linear_before_reset=1), GRU (=0); NR: the rows of the
// step's product (G J, or 2 J for GRU with linear_before_reset=0, rounded up
// to 8), NRB: the rows of its second product (J, rounded up to 8)
template <typename T, int KIND, int NR, int NRB>
__global__ void __launch_bounds__(kPThreads, 1) rnn_persistent_kernel(const RArgs a) {
  constexpr int G = KIND == kPLstm ? 4 : 3;
  extern __shared__ __align__(16) uint8_t psm[];
  const int H = a.H, B = a.B, J = a.units, j0 = blockIdx.x * J;
  const long long BH = (long long)B * H;
  const PLayout L = p_layout(KIND == kPLstm ? 0 : 1, KIND != kPGru0, sizeof(T) == 2, B, H, J);
  T* const Rs = reinterpret_cast<T*>(psm);
  T* const hbuf = reinterpret_cast<T*>(psm + L.work);
  float* const part = reinterpret_cast<float*>(psm + L.work);
  float* const state = reinterpret_cast<float*>(psm + L.state);  // c (LSTM) or own h (GRU)
  float* const zs = state + B * J;                                  // GRU lbr=0: z of the step
  const T* R = static_cast<const T*>(a.r);
  T* Y = static_cast<T*>(a.y);
  const int tid = threadIdx.x;

  // the block's rows of R (gate q, unit jj at row q J + jj), the zero row, k past H zero
  for (long long e = tid; e < (long long)L.rows * L.ldr; e += kPThreads) {
    const int r = (int)(e / L.ldr), k = (int)(e % L.ldr);
    const int q = r / J, jj = r - q * J;
    const bool ok = r < G * J && j0 + jj < H && k < H;
    Rs[e] = ok ? R[((long long)q * H + j0 + jj) * H + k] : T(0.f);
  }
  const T* init = KIND == kPLstm ? static_cast<const T*>(a.c) : static_cast<const T*>(a.h0);
  for (int e = tid; e < B * J; e += kPThreads) {
    const int b = e / J, jj = e - b * J;
    state[e] = j0 + jj < H ? ld(init, (long long)b * H + j0 + jj) : 0.f;
  }
  __syncthreads();

  const float clip = rnd<T>(a.clip);
  auto squash = [&](float v) { return a.has_clip ? fminf(fmaxf(v, -clip), clip) : v; };
  auto f = [&](float v) { return rnd<T>(act(a.act_f, squash(v))); };
  auto g = [&](float v) { return rnd<T>(act(a.act_g, squash(v))); };
  const int gw = G;  // gates a row of gx holds
  const T* P = static_cast<const T*>(a.p);
  const T* RB = static_cast<const T*>(a.rb);
  cg::grid_group grid = cg::this_grid();

  for (int t = 0; t < a.S; ++t) {
    const T* hprev = t == 0 ? static_cast<const T*>(a.h0) : Y + (t - 1) * BH;
    const T* gxt = static_cast<const T*>(a.gx) + (long long)t * B * gw * H;
    for (int b0 = 0; b0 < B; b0 += kPB) {
      product<T, NR>(hprev, B, H, b0, Rs, L, 0, KIND == kPGru0 ? 2 * J : G * J, hbuf, part);
      // this thread's (row, unit) pairs e = tid + 256 r: their gate inputs
      // and per-unit vectors
      float xin[p_pairs<KIND>()][4], vec[p_pairs<KIND>()][3];
#pragma unroll
      for (int r = 0; r < p_pairs<KIND>(); ++r) {
        const int e = tid + kPThreads * r, bl = e / J, jj = e - bl * J;
        const int b = b0 + bl, u = j0 + jj;
        const bool ok = e < kPB * J && b < B && u < H;
        const T* xg = gxt + (long long)(ok ? b : 0) * gw * H + (ok ? u : 0);
        const T* pv = KIND == kPLstm ? P : RB;
#pragma unroll
        for (int q = 0; q < G; ++q) xin[r][q] = ok ? ld(xg, (long long)q * H) : 0.f;
#pragma unroll
        for (int q = 0; q < 3; ++q) vec[r][q] = ok && pv ? ld(pv, q * H + u) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < p_pairs<KIND>(); ++r) {
        const int e = tid + kPThreads * r, bl = e / J, jj = e - bl * J;
        const int b = b0 + bl, u = j0 + jj;
        if (e >= kPB * J || b >= B || u >= H) continue;
        const long long o = (long long)b * H + u;
        float& st = state[b * J + jj];
        if constexpr (KIND == kPLstm) {
          const float pi = vec[r][0], po = vec[r][1], pf = vec[r][2];
          const float zi = add<T>(xin[r][0], rnd<T>(dot_of(part, bl, jj)));
          const float zo = add<T>(xin[r][1], rnd<T>(dot_of(part, bl, J + jj)));
          const float zf = add<T>(xin[r][2], rnd<T>(dot_of(part, bl, 2 * J + jj)));
          const float zc = add<T>(xin[r][3], rnd<T>(dot_of(part, bl, 3 * J + jj)));
          const float c = st;
          const float gi = f(add<T>(zi, mul<T>(pi, c)));
          const float gf = f(add<T>(zf, mul<T>(pf, c)));
          const float cn = add<T>(mul<T>(gf, c), mul<T>(gi, g(zc)));
          const float go = f(add<T>(zo, mul<T>(po, cn)));
          st = cn;
          st_(Y, t * BH + o, mul<T>(go, rnd<T>(act(a.act_h, cn))));
        } else {
          const float rbz = vec[r][0], rbr = vec[r][1], rbh = vec[r][2];
          const float h = st;
          const float z = f(add<T>(add<T>(xin[r][0], rnd<T>(dot_of(part, bl, jj))), rbz));
          const float rg = f(add<T>(add<T>(xin[r][1], rnd<T>(dot_of(part, bl, J + jj))), rbr));
          if constexpr (KIND == kPGru0) {
            zs[b * J + jj] = z;
            st_(static_cast<T*>(a.rh), o, mul<T>(rg, h));
          } else {
            const float hh = g(add<T>(xin[r][2],
                                      mul<T>(rg, add<T>(rnd<T>(dot_of(part, bl, 2 * J + jj)), rbh))));
            const float hn = add<T>(mul<T>(rnd<T>(__fsub_rn(1.f, z)), hh), mul<T>(z, h));
            st = hn;
            st_(Y, t * BH + o, hn);
          }
        }
      }
      __syncthreads();  // the gate math is done with part before the next tiles land
      if constexpr (KIND == kPGru0) {
        // phase B, after every unit's r h is written: (r h) R_h^T, then the new state
        grid.sync();
        product<T, NRB>(static_cast<const T*>(a.rh), B, H, b0, Rs, L, 2 * J, J, hbuf, part);
#pragma unroll
        for (int r = 0; r < p_pairs<KIND>(); ++r) {
          const int e = tid + kPThreads * r, bl = e / J, jj = e - bl * J;
          const int b = b0 + bl, u = j0 + jj;
          if (e >= kPB * J || b >= B || u >= H) continue;
          float& st = state[b * J + jj];
          const float z = zs[b * J + jj];
          const float hh = g(add<T>(add<T>(xin[r][2], rnd<T>(dot_of(part, bl, jj))), vec[r][2]));
          const float hn = add<T>(mul<T>(rnd<T>(__fsub_rn(1.f, z)), hh), mul<T>(z, st));
          st = hn;
          st_(Y, t * BH + (long long)b * H + u, hn);
        }
        __syncthreads();
      }
    }
    grid.sync();
  }
  if constexpr (KIND == kPLstm) {  // the final cell state
    for (int e = tid; e < B * J; e += kPThreads) {
      const int b = e / J, jj = e - b * J;
      if (j0 + jj < H) st_(static_cast<T*>(a.c), (long long)b * H + j0 + jj, state[e]);
    }
  }
}

template <typename T, int KIND, int NR, int NRB>
cudaError_t launch_persistent(const RArgs& a, cudaStream_t stream) {
  const PLayout L = p_layout(a.kind, a.lbr, a.bf16, a.B, a.H, a.units);
  auto kern = rnn_persistent_kernel<T, KIND, NR, NRB>;
  if (L.bytes > 0x7fffffffLL) return cudaErrorInvalidValue;
  LaunchFacts facts;
  cudaError_t err =
      launch_facts(reinterpret_cast<const void*>(kern), kPThreads, (int)L.bytes, &facts);
  if (err != cudaSuccess) return err;
  const int blocks = (a.H + a.units - 1) / a.units;
  if (blocks > facts.per_sm * facts.sms) return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kPThreads);
  cfg.dynamicSmemBytes = (size_t)L.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) {
    cudaGetLastError();  // a refused launch leaves no sticky error behind
    return err;
  }
  return cudaGetLastError();
}

// the kernel for the product's rows, rounded up to 8 (at most kPRows)
template <typename T, int KIND>
cudaError_t launch_rows(const RArgs& a, int rows, cudaStream_t stream) {
  if (a.units * kPB > kPThreads * p_pairs<KIND>()) return cudaErrorInvalidValue;
  switch ((rows + 7) / 8) {
    case 1: return launch_persistent<T, KIND, 8, 8>(a, stream);
    case 2: return launch_persistent<T, KIND, 16, 8>(a, stream);
    case 3: return launch_persistent<T, KIND, 24, 16>(a, stream);
    case 4: return launch_persistent<T, KIND, 32, 16>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run_persistent(const RArgs& a, cudaStream_t stream) {
  if (a.units < 1 || a.H % 8 != 0) return cudaErrorInvalidValue;
  if (a.kind == 0) return launch_rows<T, kPLstm>(a, 4 * a.units, stream);
  if (a.lbr) return launch_rows<T, kPGru1>(a, 3 * a.units, stream);
  return launch_rows<T, kPGru0>(a, 2 * a.units, stream);
}

}  // namespace

// One cooperative launch for all S steps (the wrapper has checked the shape
// against rnn_plan; a launch the card refuses returns its error).
extern "C" int smt_rnn_persistent(RArgs* a, void* stream) {
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != a->device && (err = cudaSetDevice(a->device)) != cudaSuccess) return (int)err;
  if (a->S > 0 && a->B > 0 && a->H > 0) {
    err = a->bf16 ? run_persistent<__nv_bfloat16>(*a, (cudaStream_t)stream)
                  : run_persistent<float>(*a, (cudaStream_t)stream);
  }
  if (prev != a->device) cudaSetDevice(prev);
  return (int)err;
}

// The device's SM count and the shared memory a block may opt in to, for the
// wrapper's plan (out[0], out[1]).
extern "C" int smt_rnn_limits(int device, int* out) {
  cudaError_t err = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[1], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return (int)err;
}

// One launch a step (two for GRU with linear_before_reset=0), S of them.
extern "C" int smt_rnn_steps(RArgs* a, void* stream) {
  int prev = -1;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return (int)err;
  if (prev != a->device && (err = cudaSetDevice(a->device)) != cudaSuccess) return (int)err;
  if (a->S > 0 && a->B > 0 && a->H > 0) {
    err = a->bf16 ? run<__nv_bfloat16>(*a, (cudaStream_t)stream) : run<float>(*a, (cudaStream_t)stream);
  }
  if (prev != a->device) cudaSetDevice(prev);
  return (int)err;
}

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
