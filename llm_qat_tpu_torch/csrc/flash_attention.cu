// Causal flash attention for sm_90a: the forward (serving, and training
// with the log-sum-exp rows) and the training backward.
//
// Replaces three Pallas kernels of llm_qat_tpu/ops/attention.py:
// - `_flash_kernel` (serving prefill, float32) with `flash_attention_fwd_f32`;
// - `_flash_fwd_kernel` (called by `_flash_fwd_call`) with `flash_fwd_lse`;
// - `_flash_bwd_kernel` (called by `_flash_train_bwd`) with
//   `flash_bwd_wgmma` (bf16 operands at head_dim 64) or `flash_bwd`, each
//   three CUDA kernels that together compute what the one TPU kernel does.
// Both forward entry points launch the one templated forward kernel; the
// serving one passes float operands and no LSE pointer. The Python wrappers
// are llm_qat_tpu_torch/ops/attention.py::flash_attention, ::flash_fwd_lse
// and ::flash_bwd; `flash_attention_plain`, `flash_fwd_lse_plain` and
// `flash_bwd_plain` beside them compute the same functions in plain PyTorch.
//
// Operands q, k, v, o, dO are (B*H, T, D) in the operand type (float or
// bf16), LSE and the row dots D are (B*H, T) float32. As in the JAX
// kernels, every product is taken from the operand values (a bf16 x bf16
// product is exact in float32) and summed in float32, with no TF32;
// `sm_scale` is applied to the float32 sums; P is rounded to the operand
// type before P.V and before dV = P^T.dO, and dS = P*(dP - D) before
// dQ = dS.K and dK = dS^T.Q; the running max/sum and all accumulators stay
// float32, and the outputs are written in the operand type. The tiles are
// 64 x 64 (the wgmma backward: 128-row blocks, 64-row steps) and the
// kernels mask the ragged tail themselves (keys and query rows >= T), so T
// need not be a multiple of the tile.
//
// Forward: one block per (b*h, 64-row q tile): K/V tiles up to the causal
// limit stream through shared memory, each of 256 threads owns a 4x4 patch
// of the score tile and 4 x D/16 output columns, with an online softmax per
// row. P is rounded at the running max of its row, as in the JAX kernel.
//
// Backward (FlashAttention-2 order, deterministic, no atomics). The JAX
// kernel holds the whole T x T of one (b, h) in VMEM; at T = 1024 that is
// 4 MB in float32, far over a block's 227 KB of shared memory, so here it
// is blocked in two passes, each output element written by exactly one
// block, which recompute S and dP:
//   1. D = rowsum(dO * O) in float32;
//   2. dK and dV per k tile: the tile's K and V stay, the q tiles from the
//      causal start stream past; per q tile S and P = exp(S*scale - LSE)
//      from the saved LSE, dP = dO.V^T, then dV += P^T.dO and dK += dS^T.Q;
//   3. dQ per q tile: Q and dO stay, the k tiles up to the causal limit
//      stream past; per k tile P and dS again, then dQ += dS.K.
// With bf16 operands at head_dim 64 (every GPT-2 size; `flash_bwd_wgmma`,
// the training path) the three are `flash_bwd_prep`, `flash_bwd_dkdv_wgmma`
// and `flash_bwd_dq_wgmma`, on the tensor cores:
// - A block of 288 threads owns a 128-row tile: two consumer warpgroups of
//   64 rows each and one producer warp. The producer's first thread loads
//   the own tiles once and keeps a 4-stage ring of 64-row tiles filled by
//   TMA (3-D tensor maps over (B*H, T, 64), 128-byte swizzle: a box past T
//   is zero-filled and never reads the next head's rows) and bulk copies
//   of the row vectors, with a full and an empty mbarrier per stage.
// - Per step a warpgroup runs two m64n64 wgmma products from shared memory
//   (S^T = K.Q^T and dP^T = V.dO^T, or S = Q.K^T and dP = dO.V^T; every
//   operand K-major over head_dim), computes P and dS in the accumulators'
//   registers, rounds them to bf16 pairs in place, and feeds them as the A
//   operand of wgmma's register form (the accumulator layout of columns
//   16 kk .. 16 kk + 15 is the A operand's layout of the k16 slice kk), so
//   P and dS never go to shared memory. The B operands of those products
//   (dO and Q for dV and dK, K for dQ) are the same shared tiles read
//   MN-major, since their reduction index is the tile's row.
// - Tiles wholly above the diagonal are skipped; tiles on the diagonal or
//   past T are masked element by element. The blocks whose walk is longest
//   launch first (the dK/dV kernel's first k tile, the dQ kernel's last q
//   tile), so that the short walks fill the last wave.
// - `flash_bwd_prep` pads each head's LSE and D to t_pad rows (a multiple
//   of 128) with zeros, so that the bulk copies of the vectors stay within
//   the head; it reads O and dO in 16-byte loads, eight threads a row.
// Other operands (float32, or bf16 at head_dim 128) run `flash_bwd_rowdot`,
// `flash_bwd_dkdv` and `flash_bwd_dq` (64-row tiles, float32 FMA on the
// CUDA cores, each thread a 4x4 patch of S and dP).
//
// Bounds. Serving forward (float32): q, k, v read once and o written once
// (16 * T * D bytes per (b, h)) and 2*T*(T+1)*D flops per (b, h) for QK^T
// and PV over the causal half, on the CUDA cores; at the serving prefill's
// T = 128 the two bounds are close, from T = 512 on it is bound by
// operations. Training, at (B, H, T, D) = (8, 12, 1024, 64) in bf16.
// Forward: q, k, v and o once (4 x 12.58 MB) plus LSE (0.39 MB), 50.7 MB,
// 15 us at 3.35 TB/s; Q.K^T and P.V over the causal half,
// 2 * 2 * D * T(T+1)/2 per (b, h), 12.9 GFLOP, 13 us at the bf16
// tensor-core peak (989 TFLOP/s): bound by bytes. Backward: q, k, v, o, dO
// read and dq, dk, dv written, 8 x 12.58 MB plus LSE, 101 MB, 30 us; five
// causal products (S, dP, dV, dQ, dK), 32.2 GFLOP, 33 us: bound by
// operations. The two-pass order recomputes S and dP: seven products,
// 45 GFLOP, 46 us at the bf16 peak, plus P and dS twice on the CUDA cores
// (an expf and about a dozen other operations per causal element and
// pass). The forward and the SIMT backward run float32 FMA on the CUDA
// cores (67 TFLOP/s), whose own ceiling for the same work is 0.19 ms
// (forward) and 0.48 ms (backward).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "sm90.cuh"

#define BQ 64
#define BK 64
#define NT 256      // 16 x 16 threads
#define PADQ (BQ + 4)
#define NEG_INF (-1e30f)

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to the operand type and back (the JAX kernels' `.astype(cdt)`)
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// ---------------------------------------------------------------------------
// Forward, with the log-sum-exp rows when lse is given
// ---------------------------------------------------------------------------

// lse may be null (the serving forward writes none).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, float* __restrict__ lse, int seq, float sm_scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem;             // [D][PADQ]  Qt[c][r] = q[r][c]
  float* Kt = Qt + D * PADQ;    // [D][PADQ]
  float* Vs = Kt + D * PADQ;    // [BK][D]
  float* Ps = Vs + BK * D;      // [BQ][BK]  P rounded to the operand type
  constexpr int DC = D / 16;    // output columns per thread

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const size_t off = (size_t)bh * seq * D;
  const T* qb = q + off;
  const T* kb = k + off;
  const T* vb = v + off;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D, gr = q0 + r;
    Qt[c * PADQ + r] = gr < seq ? to_f(qb[(size_t)gr * D + c]) : 0.f;
  }

  float acc[4][DC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int kmax = min(seq, q0 + BQ);
  const int nkb = (kmax + BK - 1) / BK;
  for (int kt = 0; kt < nkb; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's Kt/Vs/Ps fully consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D, gr = k0 + r;
      const bool in = gr < seq;
      Kt[c * PADQ + r] = in ? to_f(kb[(size_t)gr * D + c]) : 0.f;
      Vs[r * D + c] = in ? to_f(vb[(size_t)gr * D + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float4 qa = *reinterpret_cast<const float4*>(&Qt[c * PADQ + ty * 4]);
      const float4 ka = *reinterpret_cast<const float4*>(&Kt[c * PADQ + tx * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx * 4 + j;
        float x = s[i][j] * sm_scale;
        if (kj > qi || kj >= seq) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      // the 16 threads of a row group are 16 adjacent lanes of one warp
      for (int w = 8; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;                   // the row sum takes the float32 p
        s[i][j] = round_to<T>(p);  // P.V takes p in the operand type
      }
      for (int w = 8; w > 0; w >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, w);
      l[i] = l[i] * corr + rs;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * BK + tx * 4 + j] = s[i][j];
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * BK + kk];
#pragma unroll
      for (int cc = 0; cc < DC / 4; ++cc) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[kk * D + cc * 64 + tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][cc * 4 + 0] += p[i] * vv.x;
          acc[i][cc * 4 + 1] += p[i] * vv.y;
          acc[i][cc * 4 + 2] += p[i] * vv.z;
          acc[i][cc * 4 + 3] += p[i] * vv.w;
        }
      }
    }
  }

  T* ob = o + off;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi < seq) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int cc = 0; cc < DC / 4; ++cc)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ob[(size_t)qi * D + cc * 64 + tx * 4 + j] = from_f<T>(acc[i][cc * 4 + j] / den);
      if (lse != nullptr && tx == 0) lse[(size_t)bh * seq + qi] = m[i] + logf(den);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// D = rowsum(dO * O) in float32, one warp per row of the (B*H*T, D) view.
template <typename T, int D>
__global__ void flash_bwd_rowdot(const T* __restrict__ o, const T* __restrict__ dout,
                                 float* __restrict__ dvec, int rows) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const T* orow = o + (size_t)row * D;
  const T* drow = dout + (size_t)row * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += to_f(drow[c]) * to_f(orow[c]);
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) dvec[row] = s;
}

// Rows of a (64, D) tile [r0, r0 + 64) of x into shared rows of pitch D + 4
// as float, zero past the sequence end.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ x, int r0,
                                          int seq, int tid) {
  for (int i = tid; i < 64 * D; i += NT) {
    const int r = i / D, c = i % D, gr = r0 + r;
    dst[r * (D + 4) + c] = gr < seq ? to_f(x[(size_t)gr * D + c]) : 0.f;
  }
}

// The 4x4 patches of S = Q.K^T and dP = dO.V^T owned by thread (ty, tx):
// q rows ty + 16 i, k rows tx + 16 j. Rows of pitch D + 4 (4 words of bank
// shift per row), so 8 lanes reading 8 consecutive rows hit distinct banks.
template <int D>
__device__ __forceinline__ void score_patches(const float* Qs, const float* dOs,
                                              const float* Ks, const float* Vs, int ty,
                                              int tx, float s[4][4], float dp[4][4]) {
  constexpr int PD = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
  for (int c = 0; c < D; c += 4) {
    float4 qa[4], da[4], ka[4], va[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * PD + c]);
      da[i] = *reinterpret_cast<const float4*>(&dOs[(ty + 16 * i) * PD + c]);
      ka[i] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * i) * PD + c]);
      va[i] = *reinterpret_cast<const float4*>(&Vs[(tx + 16 * i) * PD + c]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] += qa[i].x * ka[j].x;
        s[i][j] += qa[i].y * ka[j].y;
        s[i][j] += qa[i].z * ka[j].z;
        s[i][j] += qa[i].w * ka[j].w;
        dp[i][j] += da[i].x * va[j].x;
        dp[i][j] += da[i].y * va[j].y;
        dp[i][j] += da[i].z * va[j].z;
        dp[i][j] += da[i].w * va[j].w;
      }
  }
}

// dK and dV for one (b*h, 64-row k tile).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ dvec, T* __restrict__ dk, T* __restrict__ dv,
               int seq, float sm_scale) {
  extern __shared__ float4 smem4[];
  constexpr int PD = D + 4, PK = BK + 4, DC = D / 16;
  float* Ks = reinterpret_cast<float*>(smem4);  // [BK][PD]
  float* Vs = Ks + BK * PD;                     // [BK][PD]
  float* Qs = Vs + BK * PD;                     // [BQ][PD]
  float* dOs = Qs + BQ * PD;                    // [BQ][PD]
  float* Ps = dOs + BQ * PD;                    // [BQ][PK]  P in the operand type
  float* dSs = Ps + BQ * PK;                    // [BQ][PK]  dS in the operand type
  float* lse_s = dSs + BQ * PK;                 // [BQ]
  float* d_s = lse_s + BQ;                      // [BQ]

  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const size_t off = (size_t)bh * seq * D;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  load_rows<T, D>(Ks, k + off, k0, seq, tid);
  load_rows<T, D>(Vs, v + off, k0, seq, tid);

  float adk[4][DC], adv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) adk[i][c] = adv[i][c] = 0.f;

  const int nq = (seq + BQ - 1) / BQ;
  for (int qt = k0 / BQ; qt < nq; ++qt) {  // q tiles from the causal start
    const int q0 = qt * BQ;
    __syncthreads();  // the previous q tile is fully consumed
    load_rows<T, D>(Qs, q + off, q0, seq, tid);
    load_rows<T, D>(dOs, dout + off, q0, seq, tid);
    if (tid < BQ) {
      const bool in = q0 + tid < seq;
      lse_s[tid] = in ? lse[(size_t)bh * seq + q0 + tid] : 0.f;
      d_s[tid] = in ? dvec[(size_t)bh * seq + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    score_patches<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kj = k0 + c;
        const float p = (qi < seq && kj <= qi) ? expf(s[i][j] * sm_scale - lse_s[r]) : 0.f;
        Ps[r * PK + c] = round_to<T>(p);
        dSs[r * PK + c] = round_to<T>(p * (dp[i][j] - d_s[r]));
      }
    }
    __syncthreads();

    // dV[kk][c] += P[q][kk] dO[q][c]; dK[kk][c] += dS[q][kk] Q[q][c] for the
    // thread's rows kk = ty*4 + i and columns cc*64 + tx*4 + (0..3)
#pragma unroll 2
    for (int qq = 0; qq < BQ; ++qq) {
      const float4 pa = *reinterpret_cast<const float4*>(&Ps[qq * PK + ty * 4]);
      const float4 sa = *reinterpret_cast<const float4*>(&dSs[qq * PK + ty * 4]);
      const float p[4] = {pa.x, pa.y, pa.z, pa.w};
      const float ds[4] = {sa.x, sa.y, sa.z, sa.w};
#pragma unroll
      for (int cc = 0; cc < DC / 4; ++cc) {
        const float4 dov = *reinterpret_cast<const float4*>(&dOs[qq * PD + cc * 64 + tx * 4]);
        const float4 qv = *reinterpret_cast<const float4*>(&Qs[qq * PD + cc * 64 + tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          adv[i][cc * 4 + 0] += p[i] * dov.x;
          adv[i][cc * 4 + 1] += p[i] * dov.y;
          adv[i][cc * 4 + 2] += p[i] * dov.z;
          adv[i][cc * 4 + 3] += p[i] * dov.w;
          adk[i][cc * 4 + 0] += ds[i] * qv.x;
          adk[i][cc * 4 + 1] += ds[i] * qv.y;
          adk[i][cc * 4 + 2] += ds[i] * qv.z;
          adk[i][cc * 4 + 3] += ds[i] * qv.w;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kk = k0 + ty * 4 + i;
    if (kk < seq) {
#pragma unroll
      for (int cc = 0; cc < DC / 4; ++cc)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const size_t idx = off + (size_t)kk * D + cc * 64 + tx * 4 + j;
          dk[idx] = from_f<T>(adk[i][cc * 4 + j] * sm_scale);
          dv[idx] = from_f<T>(adv[i][cc * 4 + j]);
        }
    }
  }
}

// dQ for one (b*h, 64-row q tile).
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const T* __restrict__ dout, const float* __restrict__ lse,
             const float* __restrict__ dvec, T* __restrict__ dq, int seq, float sm_scale) {
  extern __shared__ float4 smem4[];
  constexpr int PD = D + 4, PQ = BQ + 4, DC = D / 16;
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][PD]
  float* dOs = Qs + BQ * PD;                    // [BQ][PD]
  float* Ks = dOs + BQ * PD;                    // [BK][PD]
  float* Vs = Ks + BK * PD;                     // [BK][PD]
  float* dSt = Vs + BK * PD;                    // [BK][PQ]  dS transposed
  float* lse_s = dSt + BK * PQ;                 // [BQ]
  float* d_s = lse_s + BQ;                      // [BQ]

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const size_t off = (size_t)bh * seq * D;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  load_rows<T, D>(Qs, q + off, q0, seq, tid);
  load_rows<T, D>(dOs, dout + off, q0, seq, tid);
  if (tid < BQ) {
    const bool in = q0 + tid < seq;
    lse_s[tid] = in ? lse[(size_t)bh * seq + q0 + tid] : 0.f;
    d_s[tid] = in ? dvec[(size_t)bh * seq + q0 + tid] : 0.f;
  }

  float adq[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) adq[i][c] = 0.f;

  const int nkb = (min(seq, q0 + BQ) + BK - 1) / BK;  // k tiles to the causal limit
  for (int kt = 0; kt < nkb; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous k tile is fully consumed
    load_rows<T, D>(Ks, k + off, k0, seq, tid);
    load_rows<T, D>(Vs, v + off, k0, seq, tid);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_patches<D>(Qs, dOs, Ks, Vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kj = k0 + c;
        const float p = (qi < seq && kj <= qi) ? expf(s[i][j] * sm_scale - lse_s[r]) : 0.f;
        dSt[c * PQ + r] = round_to<T>(p * (dp[i][j] - d_s[r]));
      }
    }
    __syncthreads();

    // dQ[q][c] += dS[q][kk] K[kk][c] for the thread's rows q = ty*4 + i
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      const float4 sa = *reinterpret_cast<const float4*>(&dSt[kk * PQ + ty * 4]);
      const float ds[4] = {sa.x, sa.y, sa.z, sa.w};
#pragma unroll
      for (int cc = 0; cc < DC / 4; ++cc) {
        const float4 kv = *reinterpret_cast<const float4*>(&Ks[kk * PD + cc * 64 + tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          adq[i][cc * 4 + 0] += ds[i] * kv.x;
          adq[i][cc * 4 + 1] += ds[i] * kv.y;
          adq[i][cc * 4 + 2] += ds[i] * kv.z;
          adq[i][cc * 4 + 3] += ds[i] * kv.w;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi < seq) {
#pragma unroll
      for (int cc = 0; cc < DC / 4; ++cc)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dq[off + (size_t)qi * D + cc * 64 + tx * 4 + j] =
              from_f<T>(adq[i][cc * 4 + j] * sm_scale);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, bf16 operands at head_dim 64: TMA-fed wgmma kernels
// ---------------------------------------------------------------------------

#define W_ROWS 64      // rows of a consumer warpgroup's tile and of a streamed tile
#define W_TILE 128     // rows of a block's own tile: two consumer warpgroups
#define W_STAGES 4     // the ring of streamed tiles
#define W_THREADS 288  // two consumer warpgroups + one producer warp
#define W_HD 64        // head_dim: one 128-byte swizzle row of bf16

typedef __nv_bfloat16 bf16;

constexpr int W_BOX = W_ROWS * W_HD * 2;  // one 64-row bf16 tile (a TMA box): 8192 bytes
constexpr int W_OWN = 4 * W_BOX;          // the block's own two 128-row tiles
constexpr int W_STAGE = 2 * W_BOX;        // a stage: two 64-row tiles
// the row vectors (lse and D): 2 x 64 floats per stage for dK/dV, 2 x 128
// once for dQ
constexpr int W_VEC = W_STAGES * 2 * W_ROWS * 4;
// dynamic shared memory: 1024 bytes of alignment, the own tiles, the ring,
// the vectors, a full and an empty mbarrier per stage and one for the own tiles
constexpr int W_SMEM = 1024 + W_OWN + W_STAGES * W_STAGE + W_VEC + (2 * W_STAGES + 1) * 8;
static_assert(W_VEC >= 2 * W_TILE * 4, "dQ's vectors fit");
static_assert(W_BOX == SW128_BOX, "a streamed tile is one MN-major box");

// x, y rounded to bf16 (to nearest) as one register of the wgmma register
// form's A operand, x in the low half.
__device__ __forceinline__ uint32_t bf16x2(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared-memory addresses of a block of either kernel, its barriers
// initialised (called by all threads).
struct BwdSmem {
  uint32_t own;    // the own tiles: K, V (dK/dV) or Q, dO (dQ), 2 boxes each
  uint32_t ring;   // W_STAGES stages of two 64-row tiles
  uint32_t vec_s;  // the row vectors
  const float* vec;
  uint32_t full, empty, own_bar;
};

__device__ __forceinline__ BwdSmem bwd_smem() {
  extern __shared__ uint8_t bwd_raw[];
  const uint32_t raw = smem_u32(bwd_raw);
  BwdSmem m;
  m.own = (raw + 1023) & ~1023u;
  m.ring = m.own + W_OWN;
  m.vec_s = m.ring + W_STAGES * W_STAGE;
  m.vec = reinterpret_cast<const float*>(bwd_raw + (m.vec_s - raw));
  m.full = m.vec_s + W_VEC;
  m.empty = m.full + 8 * W_STAGES;
  m.own_bar = m.empty + 8 * W_STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(m.full + 8 * s, 1);
      mbar_init(m.empty + 8 * s, 8);  // one arrival per consumer warp
    }
    mbar_init(m.own_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return m;
}

// S = A . B^T and dP = A2 . B2^T of one warpgroup: 64 x 64 each, every
// operand a K-major 64-row tile over head_dim.
__device__ __forceinline__ void scores(float* sa, float* pa, uint32_t a, uint32_t b, uint32_t a2,
                                       uint32_t b2) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < W_HD / 16; ++kk)
    wgmma<64, false>(sa, sdesc<false>(a, kk), sdesc<false>(b, kk), kk);
#pragma unroll
  for (int kk = 0; kk < W_HD / 16; ++kk)
    wgmma<64, false>(pa, sdesc<false>(a2, kk), sdesc<false>(b2, kk), kk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc<32>(sa);
  fence_acc<32>(pa);
}

// d += A . B: A (64 x 64) the bf16 pairs `a` in registers, B a 64-row tile
// whose rows are the reduction index (MN-major). Issued, not waited for.
__device__ __forceinline__ void rs_accumulate(float* d, const uint32_t* a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < W_ROWS / 16; ++kk) wgmma_rs64<true>(d, a + 4 * kk, sdesc<true>(b, kk));
}

// In both kernels accumulator e of consumer thread t of a warpgroup is row
// 16 (t/32) + (t%32)/4 + 8 ((e>>1)&1) and column 8 (e>>2) + 2 (t%4) + (e&1)
// of its 64 x 64 tile. P and dS are computed as the JAX kernel does, each
// operation rounded on its own (no FMA contraction): exp(S*scale - lse)
// with expf, and dS = P*(dP - D) from the float32 P.

// dK and dV of the keys [k0, k0 + 128) of head bh: warpgroup w owns keys
// k0 + 64 w .. + 63, walks the 64-row q tiles from q0 = k0 to the end, and
// per tile computes S^T = K.Q^T and dP^T = V.dO^T, then P^T =
// exp(S^T*scale - lse) and dS^T = P^T*(dP^T - D) in registers, then dV +=
// bf16(P^T).dO and dK += bf16(dS^T).Q.
__device__ __forceinline__ void dkdv_block(const CUtensorMap* mq, const CUtensorMap* mk,
                                           const CUtensorMap* mv, const CUtensorMap* mdo,
                                           const float* __restrict__ lse_p,
                                           const float* __restrict__ d_p, bf16* __restrict__ dk,
                                           bf16* __restrict__ dv, int bh, int k0, int seq,
                                           int t_pad, float sm_scale) {
  const BwdSmem m = bwd_smem();
  const int n = (seq - k0 + W_ROWS - 1) / W_ROWS;  // q tiles from the causal start
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (wg == 2) {  // producer: one thread keeps the ring full
    if (t == 0) {
      mbar_expect_tx(m.own_bar, W_OWN);
      for (int b = 0; b < 2; ++b) {
        tma_load3(m.own + b * W_BOX, mk, 0, k0 + b * W_ROWS, bh, m.own_bar);
        tma_load3(m.own + (2 + b) * W_BOX, mv, 0, k0 + b * W_ROWS, bh, m.own_bar);
      }
      for (int i = 0; i < n; ++i) {
        const int s = i % W_STAGES, q0 = k0 + i * W_ROWS;
        if (i >= W_STAGES) mbar_wait(m.empty + 8 * s, (i / W_STAGES - 1) & 1);
        const uint32_t st = m.ring + s * W_STAGE, full = m.full + 8 * s;
        const size_t row = (size_t)bh * t_pad + q0;
        mbar_expect_tx(full, W_STAGE + 2 * W_ROWS * 4);
        tma_load3(st, mq, 0, q0, bh, full);
        tma_load3(st + W_BOX, mdo, 0, q0, bh, full);
        bulk_load(m.vec_s + s * 2 * W_ROWS * 4, lse_p + row, W_ROWS * 4, full);
        bulk_load(m.vec_s + (s * 2 + 1) * W_ROWS * 4, d_p + row, W_ROWS * 4, full);
      }
    }
    return;
  }

  const int kw = k0 + W_ROWS * wg, warp = t / 32, lane = t % 32, c = lane % 4;
  const int krow = kw + 16 * warp + lane / 4;  // the thread's keys: krow, krow + 8
  const uint32_t ka = m.own + wg * W_BOX, va = m.own + (2 + wg) * W_BOX;
  float dka[32], dva[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dka[e] = dva[e] = 0.f;
  mbar_wait(m.own_bar, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % W_STAGES, q0 = k0 + i * W_ROWS;
    mbar_wait(m.full + 8 * s, (i / W_STAGES) & 1);
    if (q0 + W_ROWS > kw) {  // not every (k, q) of the tile has k > q
      const uint32_t qs = m.ring + s * W_STAGE, dos = qs + W_BOX;
      const float* lse_s = m.vec + s * 2 * W_ROWS;
      const float* d_s = lse_s + W_ROWS;
      float sa[32], pa[32];
      scores(sa, pa, ka, qs, va, dos);
      const bool masked = kw + W_ROWS - 1 > q0 || q0 + W_ROWS > seq;
      uint32_t pf[16], sf[16];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 8 * j + 2 * c;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
        const float2 d2 = *reinterpret_cast<const float2*>(d_s + col);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * j + 2 * h, k = krow + 8 * h, q = q0 + col;
          float p0 = expf(__fsub_rn(__fmul_rn(sa[e], sm_scale), l2.x));
          float p1 = expf(__fsub_rn(__fmul_rn(sa[e + 1], sm_scale), l2.y));
          if (masked) {
            if (k > q || q >= seq) p0 = 0.f;
            if (k > q + 1 || q + 1 >= seq) p1 = 0.f;
          }
          pf[2 * j + h] = bf16x2(p0, p1);
          sf[2 * j + h] = bf16x2(p0 * (pa[e] - d2.x), p1 * (pa[e + 1] - d2.y));
        }
      }
      fence_acc<32>(dva);
      fence_acc<32>(dka);
      wgmma_fence();
      rs_accumulate(dva, pf, dos);
      rs_accumulate(dka, sf, qs);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc<32>(dva);
      fence_acc<32>(dka);
      fence_frag<16>(pf);
      fence_frag<16>(sf);
    }
    if (lane == 0) mbar_arrive(m.empty + 8 * s);
  }

  const size_t off = (size_t)bh * seq * W_HD;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 4 * j + 2 * h, k = krow + 8 * h;
      if (k < seq) {
        const size_t o = off + (size_t)k * W_HD + 8 * j + 2 * c;
        *reinterpret_cast<__nv_bfloat162*>(dk + o) =
            __floats2bfloat162_rn(dka[e] * sm_scale, dka[e + 1] * sm_scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + o) = __floats2bfloat162_rn(dva[e], dva[e + 1]);
      }
    }
}

// dQ of the queries [q0, q0 + 128) of head bh: warpgroup w owns queries
// q0 + 64 w .. + 63, walks the 64-row k tiles from 0 to the causal limit,
// and per tile computes S = Q.K^T and dP = dO.V^T, then P and dS in
// registers, then dQ += bf16(dS).K.
__device__ __forceinline__ void dq_block(const CUtensorMap* mq, const CUtensorMap* mk,
                                         const CUtensorMap* mv, const CUtensorMap* mdo,
                                         const float* __restrict__ lse_p,
                                         const float* __restrict__ d_p, bf16* __restrict__ dq,
                                         int bh, int q0, int seq, int t_pad, float sm_scale) {
  const BwdSmem m = bwd_smem();
  const int n = (min(seq, q0 + W_TILE) + W_ROWS - 1) / W_ROWS;  // k tiles to the causal limit
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (wg == 2) {
    if (t == 0) {
      const size_t row = (size_t)bh * t_pad + q0;
      mbar_expect_tx(m.own_bar, W_OWN + 2 * W_TILE * 4);
      for (int b = 0; b < 2; ++b) {
        tma_load3(m.own + b * W_BOX, mq, 0, q0 + b * W_ROWS, bh, m.own_bar);
        tma_load3(m.own + (2 + b) * W_BOX, mdo, 0, q0 + b * W_ROWS, bh, m.own_bar);
      }
      bulk_load(m.vec_s, lse_p + row, W_TILE * 4, m.own_bar);
      bulk_load(m.vec_s + W_TILE * 4, d_p + row, W_TILE * 4, m.own_bar);
      for (int i = 0; i < n; ++i) {
        const int s = i % W_STAGES;
        if (i >= W_STAGES) mbar_wait(m.empty + 8 * s, (i / W_STAGES - 1) & 1);
        const uint32_t st = m.ring + s * W_STAGE, full = m.full + 8 * s;
        mbar_expect_tx(full, W_STAGE);
        tma_load3(st, mk, 0, i * W_ROWS, bh, full);
        tma_load3(st + W_BOX, mv, 0, i * W_ROWS, bh, full);
      }
    }
    return;
  }

  const int qw = q0 + W_ROWS * wg, warp = t / 32, lane = t % 32, c = lane % 4;
  const int r = W_ROWS * wg + 16 * warp + lane / 4;  // the thread's rows r, r + 8 of the tile
  const uint32_t qa = m.own + wg * W_BOX, doa = m.own + (2 + wg) * W_BOX;
  float dqa[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) dqa[e] = 0.f;
  mbar_wait(m.own_bar, 0);
  const float lr[2] = {m.vec[r], m.vec[r + 8]};
  const float dr[2] = {m.vec[W_TILE + r], m.vec[W_TILE + r + 8]};
  for (int i = 0; i < n; ++i) {
    const int s = i % W_STAGES, k0 = i * W_ROWS;
    mbar_wait(m.full + 8 * s, (i / W_STAGES) & 1);
    if (k0 < qw + W_ROWS) {  // not every (q, k) of the tile has k > q
      const uint32_t ks = m.ring + s * W_STAGE, vs = ks + W_BOX;
      float sa[32], pa[32];
      scores(sa, pa, qa, ks, doa, vs);
      const bool masked = k0 + W_ROWS - 1 > qw || qw + W_ROWS > seq;
      uint32_t sf[16];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * j + 2 * h, q = q0 + r + 8 * h, k = k0 + 8 * j + 2 * c;
          float p0 = expf(__fsub_rn(__fmul_rn(sa[e], sm_scale), lr[h]));
          float p1 = expf(__fsub_rn(__fmul_rn(sa[e + 1], sm_scale), lr[h]));
          if (masked) {
            if (k > q || q >= seq) p0 = 0.f;
            if (k + 1 > q || q >= seq) p1 = 0.f;
          }
          sf[2 * j + h] = bf16x2(p0 * (pa[e] - dr[h]), p1 * (pa[e + 1] - dr[h]));
        }
      fence_acc<32>(dqa);
      wgmma_fence();
      rs_accumulate(dqa, sf, ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc<32>(dqa);
      fence_frag<16>(sf);
    }
    if (lane == 0) mbar_arrive(m.empty + 8 * s);
  }

  const size_t off = (size_t)bh * seq * W_HD;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 4 * j + 2 * h, q = q0 + r + 8 * h;
      if (q < seq)
        *reinterpret_cast<__nv_bfloat162*>(dq + off + (size_t)q * W_HD + 8 * j + 2 * c) =
            __floats2bfloat162_rn(dqa[e] * sm_scale, dqa[e + 1] * sm_scale);
    }
}

// Blocks (bh, y): the k tile y, so the tile whose walk over the q tiles is
// longest comes first.
__global__ void __launch_bounds__(W_THREADS, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
                     const float* __restrict__ lse_p, const float* __restrict__ d_p,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int seq, int t_pad,
                     float sm_scale) {
  dkdv_block(&mq, &mk, &mv, &mdo, lse_p, d_p, dk, dv, blockIdx.x, blockIdx.y * W_TILE, seq,
             t_pad, sm_scale);
}

// Blocks (bh, y): the q tile gridDim.y - 1 - y, so the last q tile, whose
// walk over the k tiles is longest, comes first.
__global__ void __launch_bounds__(W_THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
                   const float* __restrict__ lse_p, const float* __restrict__ d_p,
                   bf16* __restrict__ dq, int seq, int t_pad, float sm_scale) {
  const int y = gridDim.y - 1 - blockIdx.y;
  dq_block(&mq, &mk, &mv, &mdo, lse_p, d_p, dq, blockIdx.x, y * W_TILE, seq, t_pad, sm_scale);
}

// The row vectors of the wgmma kernels, each head's rows padded to t_pad
// with zeros: lse_p[bh][t] = lse and d_p[bh][t] = D = rowsum(dO * O) in
// float32. Eight threads a row, 16 bytes of O and of dO each.
__global__ void __launch_bounds__(256)
flash_bwd_prep(const bf16* __restrict__ o, const bf16* __restrict__ dout,
               const float* __restrict__ lse, float* __restrict__ lse_p, float* __restrict__ d_p,
               int seq, int t_pad) {
  const int id = blockIdx.x * 256 + threadIdx.x, row = id / 8, part = id % 8;
  const int bh = row / t_pad, tt = row % t_pad;  // rows = BH * t_pad, a multiple of 32
  float s = 0.f;
  if (tt < seq) {
    const size_t at = ((size_t)bh * seq + tt) * W_HD + part * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(o + at);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + at);
    const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(b2[i]);
      s += y.x * x.x;
      s += y.y * x.y;
    }
  }
  for (int w = 4; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (part == 0) {
    lse_p[row] = tt < seq ? lse[(size_t)bh * seq + tt] : 0.f;
    d_p[row] = s;
  }
}

// ---------------------------------------------------------------------------
// Host entry points (plain C interface, loaded with ctypes)
// ---------------------------------------------------------------------------

template <typename K>
static cudaError_t set_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
static int fwd_launch(const void* q, const void* k, const void* v, void* o, float* lse,
                      int BH, int seq, float sm_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * D * PADQ + BK * D + BQ * BK);
  cudaError_t e = set_smem(flash_fwd<T, D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((seq + BQ - 1) / BQ, BH);
  flash_fwd<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, seq, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
static int bwd_launch(const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* dvec, void* dq, void* dk,
                      void* dv, int BH, int seq, float sm_scale, cudaStream_t stream) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const int rows = BH * seq;
  flash_bwd_rowdot<T, D><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(o), dop, dvec, rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  constexpr int PD = D + 4;
  const size_t smem_kv = sizeof(float) * (4 * BK * PD + 2 * BQ * (BK + 4) + 2 * BQ);
  if ((e = set_smem(flash_bwd_dkdv<T, D>, smem_kv)) != cudaSuccess) return (int)e;
  flash_bwd_dkdv<T, D><<<dim3((seq + BK - 1) / BK, BH), NT, smem_kv, stream>>>(
      qp, kp, vp, dop, lse, dvec, static_cast<T*>(dk), static_cast<T*>(dv), seq, sm_scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const size_t smem_q = sizeof(float) * (4 * BK * PD + BK * (BQ + 4) + 2 * BQ);
  if ((e = set_smem(flash_bwd_dq<T, D>, smem_q)) != cudaSuccess) return (int)e;
  flash_bwd_dq<T, D><<<dim3((seq + BQ - 1) / BQ, BH), NT, smem_q, stream>>>(
      qp, kp, vp, dop, lse, dvec, static_cast<T*>(dq), seq, sm_scale);
  return (int)cudaGetLastError();
}

// Serving forward: o from float q, k, v (BH, T, D), no LSE.
extern "C" int flash_attention_fwd_f32(const float* q, const float* k, const float* v,
                                       float* o, int BH, int T, int D, float sm_scale,
                                       cudaStream_t stream) {
  if (D == 64) return fwd_launch<float, 64>(q, k, v, o, nullptr, BH, T, sm_scale, stream);
  if (D == 128) return fwd_launch<float, 128>(q, k, v, o, nullptr, BH, T, sm_scale, stream);
  return (int)cudaErrorInvalidValue;
}

// Training forward: o and lse from q, k, v (BH, T, D) in float (is_bf16 = 0)
// or bf16.
extern "C" int flash_fwd_lse(const void* q, const void* k, const void* v, void* o,
                             float* lse, int BH, int seq, int D, int is_bf16,
                             float sm_scale, cudaStream_t stream) {
  if (is_bf16) {
    if (D == 64) return fwd_launch<__nv_bfloat16, 64>(q, k, v, o, lse, BH, seq, sm_scale, stream);
    if (D == 128) return fwd_launch<__nv_bfloat16, 128>(q, k, v, o, lse, BH, seq, sm_scale, stream);
  } else {
    if (D == 64) return fwd_launch<float, 64>(q, k, v, o, lse, BH, seq, sm_scale, stream);
    if (D == 128) return fwd_launch<float, 128>(q, k, v, o, lse, BH, seq, sm_scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// dq, dk, dv from q, k, v, o, dout, lse; dvec is (BH * T) float32 scratch.
// float operands at head_dim 64 or 128, bf16 at 128 (bf16 at 64 is
// flash_bwd_wgmma's).
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, float* dvec, void* dq,
                         void* dk, void* dv, int BH, int seq, int D, int is_bf16,
                         float sm_scale, cudaStream_t stream) {
  if (is_bf16) {
    if (D == 128)
      return bwd_launch<__nv_bfloat16, 128>(q, k, v, o, dout, lse, dvec, dq, dk, dv, BH, seq,
                                            sm_scale, stream);
  } else {
    if (D == 64)
      return bwd_launch<float, 64>(q, k, v, o, dout, lse, dvec, dq, dk, dv, BH, seq, sm_scale,
                                   stream);
    if (D == 128)
      return bwd_launch<float, 128>(q, k, v, o, dout, lse, dvec, dq, dk, dv, BH, seq, sm_scale,
                                    stream);
  }
  return (int)cudaErrorInvalidValue;
}

// #6 with bf16 operands at head_dim 64: dq, dk, dv from q, k, v, o, dout
// (BH, seq, 64) bf16, 16-byte aligned, and lse (BH * seq) float32; aux is
// (2, BH, t_pad) float32 scratch, t_pad a multiple of 128 and at least
// seq. One call: the four tensor maps, then the row vectors, the dK/dV
// kernel and the dQ kernel, three launches.
extern "C" int flash_bwd_wgmma(const void* q, const void* k, const void* v, const void* o,
                               const void* dout, const float* lse, float* aux, void* dq,
                               void* dk, void* dv, int BH, int seq, int t_pad,
                               float sm_scale, cudaStream_t stream) {
  if (seq < 1 || t_pad < seq || t_pad % W_TILE) return (int)cudaErrorInvalidValue;
  for (const void* p : {q, k, v, o, dout, (const void*)dq, (const void*)dk, (const void*)dv})
    if (reinterpret_cast<uintptr_t>(p) & 15) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  int rc = bf16_map3(&mq, q, seq, BH, W_ROWS);
  if (!rc) rc = bf16_map3(&mk, k, seq, BH, W_ROWS);
  if (!rc) rc = bf16_map3(&mv, v, seq, BH, W_ROWS);
  if (!rc) rc = bf16_map3(&mdo, dout, seq, BH, W_ROWS);
  if (rc) return rc;
  static const cudaError_t e_kv = set_smem(flash_bwd_dkdv_wgmma, W_SMEM);
  static const cudaError_t e_q = set_smem(flash_bwd_dq_wgmma, W_SMEM);
  if (e_kv != cudaSuccess) return (int)e_kv;
  if (e_q != cudaSuccess) return (int)e_q;
  float* lse_p = aux;
  float* d_p = aux + (size_t)BH * t_pad;
  flash_bwd_prep<<<BH * t_pad / 32, 256, 0, stream>>>(static_cast<const bf16*>(o),
                                                      static_cast<const bf16*>(dout), lse, lse_p,
                                                      d_p, seq, t_pad);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(BH, (seq + W_TILE - 1) / W_TILE);
  flash_bwd_dkdv_wgmma<<<grid, W_THREADS, W_SMEM, stream>>>(
      mq, mk, mv, mdo, lse_p, d_p, static_cast<bf16*>(dk), static_cast<bf16*>(dv), seq, t_pad,
      sm_scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  flash_bwd_dq_wgmma<<<grid, W_THREADS, W_SMEM, stream>>>(
      mq, mk, mv, mdo, lse_p, d_p, static_cast<bf16*>(dq), seq, t_pad, sm_scale);
  return (int)cudaGetLastError();
}
