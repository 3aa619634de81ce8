// Causal flash attention for sm_90a: the forward (serving, and training
// with the log-sum-exp rows) and the training backward.
//
// Replaces three Pallas kernels of llm_qat_tpu/ops/attention.py:
// - `_flash_kernel` (serving prefill, float32) with `flash_attention_fwd_f32`;
// - `_flash_fwd_kernel` (called by `_flash_fwd_call`) with `flash_fwd_lse`;
// - `_flash_bwd_kernel` (called by `_flash_train_bwd`) with `flash_bwd`,
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
// 64 x 64 and the kernels mask the ragged tail themselves (keys and query
// rows >= T), so T need not be a multiple of the tile.
//
// Forward: one block per (b*h, 64-row q tile): K/V tiles up to the causal
// limit stream through shared memory, each of 256 threads owns a 4x4 patch
// of the score tile and 4 x D/16 output columns, with an online softmax per
// row. P is rounded at the running max of its row, as in the JAX kernel.
//
// Backward (FlashAttention-2 order, deterministic, no atomics). The JAX
// kernel holds the whole T x T of one (b, h) in VMEM; at T = 1024 that is
// 4 MB in float32, far over a block's 227 KB of shared memory, so here it
// is blocked:
//   1. flash_bwd_rowdot: D = rowsum(dO * O) in float32, one warp per row;
//   2. flash_bwd_dkdv: one block per (b*h, 64-row k tile); it keeps K and V
//      in shared memory, walks the q tiles from the causal start, recomputes
//      S and P = exp(S*scale - LSE) from the saved LSE, dP = dO.V^T, and
//      accumulates dV and dK in float32 registers;
//   3. flash_bwd_dq: one block per (b*h, 64-row q tile); it keeps Q and dO,
//      walks the k tiles up to the causal limit, recomputes P and dS, and
//      accumulates dQ.
// S and dP are computed twice (in 2 and 3), which keeps every output
// written by exactly one block.
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
// operations. These kernels run on the CUDA cores (float32 FMA,
// 67 TFLOP/s), whose own ceiling for the same work is 0.19 ms (forward) and
// 0.48 ms (backward); the recomputed S and dP add two more products to the
// backward. Reaching the tensor-core bound takes wgmma with TMA-fed tiles,
// which is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, float* dvec, void* dq,
                         void* dk, void* dv, int BH, int seq, int D, int is_bf16,
                         float sm_scale, cudaStream_t stream) {
  if (is_bf16) {
    if (D == 64)
      return bwd_launch<__nv_bfloat16, 64>(q, k, v, o, dout, lse, dvec, dq, dk, dv, BH, seq,
                                           sm_scale, stream);
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
