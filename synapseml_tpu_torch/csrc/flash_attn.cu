// Kernel C: flash attention forward.
//
// Replaces: synapseml_tpu/parallel/flash.py::_flash_bh_impl (flash.py:193,
// the Pallas kernel launched by pl.pallas_call at flash.py:272). Forward-only
// blockwise attention with an online softmax: scores q.k^T / sqrt(D), the
// causal diagonal aligned to the END of the keys (diag_off = S_k - S_q),
// masked scores a finite -1e30, key tiles wholly above the diagonal skipped,
// running max m and denominator l in f32, an f32 accumulator, P cast to the
// input dtype before P.V, output acc / max(l, 1e-30) in the input dtype. GQA:
// query head h reads K/V head h / (H / H_kv); K/V are never expanded.
//
// Layout: q/o (B, S_q, H, D), k/v (B, S_k, H_kv, D), read strided in place
// (a row of D values is contiguous; rows of one head are H*D apart), so the
// caller needs no transposes.
//
// Bound on the H100: operations for long sequences. 4*B*H*S_q*S_k*D flops
// (about half of that causal) at 989 TFLOP/s in bf16, against q, k, v, o
// read or written once at 3.35 TB/s. At S = 8k..32k, D = 64 the flop bound
// is 10-100x the byte bound, so the tensor-core rate is what counts.
//
// Design (bf16): one CTA of 4 warps per (batch*head, 64-query tile); each
// warp owns 16 query rows. Q fragments stay in registers for the whole key
// loop; 64-key tiles of K and V are staged in shared memory (rows padded by
// 16 bytes: conflict-free fragment loads). S = Q.K^T and O += P.V run on the
// tensor cores as mma.sync.m16n8k16 (bf16 in, f32 accumulate); the S
// accumulator's register layout is the A-operand layout of the P.V product,
// so P never leaves registers. Row max and row sum reduce across the four
// lanes that share a row with two shuffles. Out-of-range keys and queries
// (ragged tails) are masked in-kernel and their K/V rows zero-filled, so any
// sequence length works. This is the simple version: no cp.async/TMA
// pipelining of the next tile and no wgmma yet.
//
// Design (f32): one thread per query row, 128 rows per CTA, 32-key tiles of
// K and V in shared memory read as broadcasts, FMA dot products, the same
// online-softmax recurrence per tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, H, Hkv, D;
  int causal;
};

// ---------------------------------------------------------------- bf16 ----

constexpr int kBQ = 64;   // query rows per CTA (4 warps x 16)
constexpr int kBK = 64;   // keys per tile
constexpr int kWarps = 4;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Copy `rows` rows of D bf16 (global row stride `stride` elements) into a
// shared tile with row stride D+8; rows past `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                         long long stride, int rows, int valid) {
  constexpr int kVec = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * kVec; i += blockDim.x) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r < valid) val = *reinterpret_cast<const uint4*>(src + r * stride + c);
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_bf16_kernel(Args a) {
  constexpr int LD = D + 8;
  static_assert(kBQ == kBK, "the Q tile is staged in the K buffer");
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK * LD];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBK * LD];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = blockIdx.x * kBQ;
  const int diag = a.Sk - a.Sq;
  const float scale = 1.f / sqrtf((float)D);

  const long long qstride = (long long)a.H * D;
  const long long kstride = (long long)a.Hkv * D;
  const __nv_bfloat16* qg = (const __nv_bfloat16*)a.q + ((long long)b * a.Sq + q0) * qstride + (long long)h * D;
  const __nv_bfloat16* kg = (const __nv_bfloat16*)a.k + (long long)b * a.Sk * kstride + (long long)hk * D;
  const __nv_bfloat16* vg = (const __nv_bfloat16*)a.v + (long long)b * a.Sk * kstride + (long long)hk * D;

  // the Q tile passes through the K buffer (static shared memory stays
  // under 48 KB at D = 128) on its way to registers
  const __nv_bfloat16* Qs = Ks;
  load_tile<D>(Ks, qg, qstride, kBQ, min(kBQ, a.Sq - q0));
  __syncthreads();

  // Q fragments (A operand, 16 x 16 per k-chunk) for this warp's 16 rows
  uint32_t qf[D / 16][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    const int c = kc * 16 + 2 * t;
    qf[kc][0] = *reinterpret_cast<const uint32_t*>(&Qs[r0 * LD + c]);
    qf[kc][1] = *reinterpret_cast<const uint32_t*>(&Qs[(r0 + 8) * LD + c]);
    qf[kc][2] = *reinterpret_cast<const uint32_t*>(&Qs[r0 * LD + c + 8]);
    qf[kc][3] = *reinterpret_cast<const uint32_t*>(&Qs[(r0 + 8) * LD + c + 8]);
  }

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  const int qpos[2] = {q0 + r0 + diag, q0 + r0 + 8 + diag};

  int n_tiles = (a.Sk + kBK - 1) / kBK;
  if (a.causal) {
    // the block's last live query sees keys up to its position; later tiles
    // lie wholly above the diagonal
    const int last = min(q0 + kBQ, a.Sq) - 1 + diag;
    n_tiles = min(n_tiles, last / kBK + 1);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    __syncthreads();
    load_tile<D>(Ks, kg + (long long)k0 * kstride, kstride, kBK, min(kBK, a.Sk - k0));
    load_tile<D>(Vs, vg + (long long)k0 * kstride, kstride, kBK, min(kBK, a.Sk - k0));
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int nc = 0; nc < kBK / 8; ++nc) {
      s[nc][0] = s[nc][1] = s[nc][2] = s[nc][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        const __nv_bfloat16* kr = &Ks[(nc * 8 + g) * LD + kc * 16 + 2 * t];
        mma_bf16(s[nc], qf[kc], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    const bool need_mask = (k0 + kBK > a.Sk) ||
                           (a.causal && k0 + kBK - 1 > q0 + diag);
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int nc = 0; nc < kBK / 8; ++nc) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float val = s[nc][i] * scale;
        if (need_mask) {
          const int kpos = k0 + nc * 8 + 2 * t + (i & 1);
          if (kpos >= a.Sk || (a.causal && qpos[i >> 1] < kpos)) val = kNeg;
        }
        s[nc][i] = val;
        mx[i >> 1] = fmaxf(mx[i >> 1], val);
      }
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int nc = 0; nc < kBK / 8; ++nc) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[nc][i] - m[i >> 1]);
        s[nc][i] = p;
        rs[i >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffff, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffff, rs[r], 2);
      l[r] = l[r] * corr[r] + rs[r];
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      o[dn][0] *= corr[0];
      o[dn][1] *= corr[0];
      o[dn][2] *= corr[1];
      o[dn][3] *= corr[1];
    }
    // O += P.V: P (16 x 64 keys) from registers, V from shared memory
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pa[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pa[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pa[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
      const int kr = kc * 16 + 2 * t;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const int col = dn * 8 + g;
        const uint32_t b0 = pack_raw(Vs[kr * LD + col], Vs[(kr + 1) * LD + col]);
        const uint32_t b1 = pack_raw(Vs[(kr + 8) * LD + col], Vs[(kr + 9) * LD + col]);
        mma_bf16(o[dn], pa, b0, b1);
      }
    }
  }

  __nv_bfloat16* og = (__nv_bfloat16*)a.o + ((long long)b * a.Sq + q0) * qstride + (long long)h * D;
  const float inv0 = 1.f / fmaxf(l[0], 1e-30f), inv1 = 1.f / fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (q0 + r0 < a.Sq)
      *reinterpret_cast<uint32_t*>(og + r0 * qstride + col) =
          pack_bf16(o[dn][0] * inv0, o[dn][1] * inv0);
    if (q0 + r0 + 8 < a.Sq)
      *reinterpret_cast<uint32_t*>(og + (r0 + 8) * qstride + col) =
          pack_bf16(o[dn][2] * inv1, o[dn][3] * inv1);
  }
}

// ----------------------------------------------------------------- f32 ----

constexpr int kBQ32 = 128;
constexpr int kBK32 = 32;

template <int D>
__global__ void __launch_bounds__(kBQ32) flash_f32_kernel(Args a) {
  __shared__ float Ks[kBK32 * D];
  __shared__ float Vs[kBK32 * D];
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh % a.H;
  const int hk = h / (a.H / a.Hkv);
  const int q0 = blockIdx.x * kBQ32;
  const int qi = q0 + threadIdx.x;
  const int diag = a.Sk - a.Sq;
  const float scale = 1.f / sqrtf((float)D);
  const long long qstride = (long long)a.H * D;
  const long long kstride = (long long)a.Hkv * D;
  const float* kg = (const float*)a.k + (long long)b * a.Sk * kstride + (long long)hk * D;
  const float* vg = (const float*)a.v + (long long)b * a.Sk * kstride + (long long)hk * D;

  float q[D], acc[D];
  const bool live = qi < a.Sq;
  const float* qr = (const float*)a.q + ((long long)b * a.Sq + (live ? qi : 0)) * qstride + (long long)h * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = live ? qr[d] : 0.f;
    acc[d] = 0.f;
  }
  float m = kNeg, l = 0.f;
  const int qpos = qi + diag;

  int n_tiles = (a.Sk + kBK32 - 1) / kBK32;
  if (a.causal) {
    const int last = min(q0 + kBQ32, a.Sq) - 1 + diag;
    n_tiles = min(n_tiles, last / kBK32 + 1);
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK32;
    const int valid = min(kBK32, a.Sk - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kBK32 * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      Ks[i] = r < valid ? kg[(long long)(k0 + r) * kstride + c] : 0.f;
      Vs[i] = r < valid ? vg[(long long)(k0 + r) * kstride + c] : 0.f;
    }
    __syncthreads();
    float sc[kBK32];
    float mx = kNeg;
#pragma unroll
    for (int kk = 0; kk < kBK32; ++kk) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(q[d], Ks[kk * D + d], dot);
      float val = dot * scale;
      const int kpos = k0 + kk;
      if (kpos >= a.Sk || (a.causal && qpos < kpos)) val = kNeg;
      sc[kk] = val;
      mx = fmaxf(mx, val);
    }
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    m = m_new;
    float rs = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= corr;
#pragma unroll
    for (int kk = 0; kk < kBK32; ++kk) {
      const float p = expf(sc[kk] - m_new);
      rs += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, Vs[kk * D + d], acc[d]);
    }
    l = l * corr + rs;
  }
  if (live) {
    float* orow = (float*)a.o + ((long long)b * a.Sq + qi) * qstride + (long long)h * D;
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < D; ++d) orow[d] = acc[d] * inv;
  }
}

template <int D>
cudaError_t launch_d(const Args& a, int bf16, cudaStream_t stream) {
  if (bf16) {
    dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.H);
    flash_bf16_kernel<D><<<grid, kWarps * 32, 0, stream>>>(a);
  } else {
    dim3 grid((a.Sq + kBQ32 - 1) / kBQ32, a.B * a.H);
    flash_f32_kernel<D><<<grid, kBQ32, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int smt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             int bf16, int B, int Sq, int Sk, int H, int Hkv, int D,
                             int causal, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || H % Hkv) return (int)cudaErrorInvalidValue;
  if (causal && Sq > Sk) return (int)cudaErrorInvalidValue;
  if ((long long)B * H > 65535) return (int)cudaErrorInvalidConfiguration;
  Args a{q, k, v, o, B, Sq, Sk, H, Hkv, D, causal};
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return (int)launch_d<16>(a, bf16, s);
    case 32: return (int)launch_d<32>(a, bf16, s);
    case 64: return (int)launch_d<64>(a, bf16, s);
    case 128: return (int)launch_d<128>(a, bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* smt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
