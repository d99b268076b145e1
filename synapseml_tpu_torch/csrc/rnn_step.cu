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
// One launch a step (two for GRU with linear_before_reset=0, whose second
// product needs r of every unit first: the first launch writes z and r h, the
// second the new state), all S steps launched from one C call on one stream.
// A block takes 32 batch rows and 16 hidden units, all of their gates, so the
// gate math of a (row, unit) pair is one thread's: a thread holds the dots of
// two rows (b, b + 16) for every gate of its unit, k in tiles of 32 through
// shared memory (h of the block's rows, and the G x 16 rows of R). h_{t-1} is
// read from Y[t-1] (Y[t] is h_t), the cell state is updated in place (only
// its own thread reads it).
//
// f32 and bf16: in bf16 every operand is bf16 and the dots accumulate in f32;
// each op of the reference's step rounds to bf16 where the reference's op
// leaves bf16 (the dot, each add and product, each activation). In f32 the
// same ops, each rounded once (no contraction into FMAs outside the dot).
//
// Bound on the H100: operations, 2 S B G H^2 at the f32 rate (f32) or the
// bf16 tensor-core rate (bf16), at GNMT's width (S=128, B=64, H=1024).
// This design is right and simple: the dots on the CUDA cores, R read from
// L2 every step. A persistent kernel with R's rows resident in a cluster's
// shared memory, on the tensor cores, is the later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
};

namespace {

constexpr int kBT = 32, kJT = 16, kKT = 32, kThreads = 256;
enum { kLstm = 0, kGruLbr = 1, kGruA = 2, kGruB = 3 };

template <int MODE>
struct Gates {
  static constexpr int n = MODE == kLstm ? 4 : MODE == kGruLbr ? 3 : MODE == kGruA ? 2 : 1;
};

__device__ __forceinline__ float ld(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, long long i, float v) {
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

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) rnn_step_kernel(const RArgs a, int t) {
  constexpr int G = Gates<MODE>::n;
  __shared__ float hs[kBT][kKT + 1];
  __shared__ float rs[G * kJT][kKT + 1];

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

  const int tid = threadIdx.x, j = tid % kJT, bp = tid / kJT;
  const int j0 = blockIdx.x * kJT, b0 = blockIdx.y * kBT;
  float acc[2][G];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int q = 0; q < G; ++q) acc[u][q] = 0.f;

  for (int k0 = 0; k0 < H; k0 += kKT) {
    for (int e = tid; e < kBT * kKT; e += kThreads) {
      const int row = e / kKT, k = k0 + e % kKT, b = b0 + row;
      hs[row][e % kKT] = (b < B && k < H) ? ld(src, (long long)b * H + k) : 0.f;
    }
    for (int e = tid; e < G * kJT * kKT; e += kThreads) {
      const int row = e / kKT, q = row / kJT, jj = j0 + row % kJT, k = k0 + e % kKT;
      rs[row][e % kKT] =
          (jj < H && k < H) ? ld(R, ((long long)(gate0 + q) * H + jj) * H + k) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kKT; ++k) {
      const float h_a = hs[bp][k], h_b = hs[bp + 16][k];
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const float w = rs[q * kJT + j][k];
        acc[0][q] = fmaf(h_a, w, acc[0][q]);
        acc[1][q] = fmaf(h_b, w, acc[1][q]);
      }
    }
    __syncthreads();
  }

  const int jj = j0 + j;
  if (jj >= H) return;
  const int gw = MODE == kLstm ? 4 : 3;   // gates a row of gx holds
  const T* gxt = static_cast<const T*>(a.gx) + (long long)t * B * gw * H;
  const float clip = rnd<T>(a.clip);
  auto squash = [&](float v) { return a.has_clip ? fminf(fmaxf(v, -clip), clip) : v; };
  auto f = [&](float v) { return rnd<T>(act(a.act_f, squash(v))); };
  auto g = [&](float v) { return rnd<T>(act(a.act_g, squash(v))); };
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int b = b0 + bp + 16 * u;
    if (b >= B) continue;
    const long long o = (long long)b * H + jj;
    const T* xg = gxt + (long long)b * gw * H;
    if constexpr (MODE == kLstm) {
      const T* P = static_cast<const T*>(a.p);
      T* C = static_cast<T*>(a.c);
      const float pi = P ? ld(P, jj) : 0.f, po = P ? ld(P, H + jj) : 0.f,
                  pf = P ? ld(P, 2 * H + jj) : 0.f;
      const float zi = add<T>(ld(xg, jj), rnd<T>(acc[u][0]));
      const float zo = add<T>(ld(xg, H + jj), rnd<T>(acc[u][1]));
      const float zf = add<T>(ld(xg, 2 * H + jj), rnd<T>(acc[u][2]));
      const float zc = add<T>(ld(xg, 3 * H + jj), rnd<T>(acc[u][3]));
      const float c = ld(C, o);
      const float gi = f(add<T>(zi, mul<T>(pi, c)));
      const float gf = f(add<T>(zf, mul<T>(pf, c)));
      const float cn = add<T>(mul<T>(gf, c), mul<T>(gi, g(zc)));
      const float go = f(add<T>(zo, mul<T>(po, cn)));
      st(C, o, cn);
      st(static_cast<T*>(a.y), t * BH + o, mul<T>(go, rnd<T>(act(a.act_h, cn))));
    } else {
      const T* RB = static_cast<const T*>(a.rb);
      const float rbz = RB ? ld(RB, jj) : 0.f, rbr = RB ? ld(RB, H + jj) : 0.f,
                  rbh = RB ? ld(RB, 2 * H + jj) : 0.f;
      const float h = ld(hprev, o);
      float z, hh;
      if constexpr (MODE == kGruLbr || MODE == kGruA) {
        z = f(add<T>(add<T>(ld(xg, jj), rnd<T>(acc[u][0])), rbz));
        const float r = f(add<T>(add<T>(ld(xg, H + jj), rnd<T>(acc[u][1])), rbr));
        if constexpr (MODE == kGruA) {
          st(static_cast<T*>(a.z), o, z);
          st(static_cast<T*>(a.rh), o, mul<T>(r, h));
          continue;
        } else {
          hh = g(add<T>(ld(xg, 2 * H + jj), mul<T>(r, add<T>(rnd<T>(acc[u][2]), rbh))));
        }
      } else {
        z = ld(static_cast<const T*>(a.z), o);
        hh = g(add<T>(add<T>(ld(xg, 2 * H + jj), rnd<T>(acc[u][0])), rbh));
      }
      st(static_cast<T*>(a.y), t * BH + o,
         add<T>(mul<T>(rnd<T>(__fsub_rn(1.f, z)), hh), mul<T>(z, h)));
    }
  }
}

template <typename T>
cudaError_t run(const RArgs& a, cudaStream_t stream) {
  const dim3 grid((a.H + kJT - 1) / kJT, (a.B + kBT - 1) / kBT);
  for (int t = 0; t < a.S; ++t) {
    if (a.kind == 0) {
      rnn_step_kernel<T, kLstm><<<grid, kThreads, 0, stream>>>(a, t);
    } else if (a.lbr) {
      rnn_step_kernel<T, kGruLbr><<<grid, kThreads, 0, stream>>>(a, t);
    } else {
      rnn_step_kernel<T, kGruA><<<grid, kThreads, 0, stream>>>(a, t);
      rnn_step_kernel<T, kGruB><<<grid, kThreads, 0, stream>>>(a, t);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

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
