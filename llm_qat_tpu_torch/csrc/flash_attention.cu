// Causal flash-attention forward in float32, for sm_90a.
//
// Replaces the Pallas kernel `_flash_kernel` behind `flash_attention` in
// llm_qat_tpu/ops/attention.py. The Python wrapper is
// llm_qat_tpu_torch/ops/attention.py::flash_attention, and
// `flash_attention_plain` beside it computes the same function in plain
// PyTorch.
//
// The serving prefill hands this kernel float32 q, k, v (B*H, T, D), so the
// scores are computed from float32 operands on the CUDA cores (no TF32).
// One block per (b*h, 64-row q tile): K/V tiles of 64 rows up to the causal
// limit go through shared memory, each thread owns a 4x4 patch of the score
// tile and 4 x D/16 output columns, and the softmax keeps a running max and
// sum per row; every sum (q.k, the row sum of p, p.V) accumulates in
// float32, as in the JAX kernel. The plain PyTorch version is the dense
// causal softmax in float32, so the two differ by float32 rounding in
// another summation order. The kernel masks the ragged tail itself (keys >= T are masked, query rows >=
// T are not stored), so T need not be a multiple of the tile.
//
// Bound. The function's bytes are q, k, v read once and o written once
// (16 * T * D per (b, h)); its operations are 2*T*(T+1)*D flops per
// (b, h) for QK^T and PV over the causal half. At the serving
// prefill's T = 128 the two bounds are close; from T = 512 on it is bound
// by operations.

#include <cuda_runtime.h>
#include <stdint.h>

#define BQ 64
#define BK 64
#define PADQ (BQ + 4)  // row pitch of the transposed Q/K tiles (keeps float4 alignment)
#define NT 256         // 16 x 16 threads
#define NEG_INF (-1e30f)

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, int T,
              float sm_scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem;             // [D][PADQ]  Qt[c][r] = q[r][c]
  float* Kt = Qt + D * PADQ;    // [D][PADQ]
  float* Vs = Kt + D * PADQ;    // [BK][D]
  float* Ps = Vs + BK * D;      // [BQ][BK]
  constexpr int DC = D / 16;    // output columns per thread

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const size_t off = (size_t)bh * T * D;
  const float* qb = q + off;
  const float* kb = k + off;
  const float* vb = v + off;
  float* ob = o + off;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  for (int i = tid; i < BQ * D; i += NT) {
    const int r = i / D, c = i % D, gr = q0 + r;
    Qt[c * PADQ + r] = gr < T ? qb[(size_t)gr * D + c] : 0.f;
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

  const int kmax = min(T, q0 + BQ);
  const int nkb = (kmax + BK - 1) / BK;
  for (int kt = 0; kt < nkb; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile's Kt/Vs/Ps fully consumed
    for (int i = tid; i < BK * D; i += NT) {
      const int r = i / D, c = i % D, gr = k0 + r;
      const bool in = gr < T;
      Kt[c * PADQ + r] = in ? kb[(size_t)gr * D + c] : 0.f;
      Vs[r * D + c] = in ? vb[(size_t)gr * D + c] : 0.f;
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
        if (kj > qi || kj >= T) x = NEG_INF;
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
        s[i][j] = p;
        rs += p;
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

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi < T) {
      const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int cc = 0; cc < DC / 4; ++cc)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ob[(size_t)qi * D + cc * 64 + tx * 4 + j] = acc[i][cc * 4 + j] / den;
    }
  }
}

template <int D>
static int launch(const float* q, const float* k, const float* v, float* o, int BH,
                  int T, float sm_scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * D * PADQ + BK * D + BQ * BK);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_f32<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + BQ - 1) / BQ, BH);
  flash_fwd_f32<D><<<grid, NT, smem, stream>>>(q, k, v, o, T, sm_scale);
  return (int)cudaGetLastError();
}

extern "C" int flash_attention_fwd_f32(const float* q, const float* k, const float* v,
                                       float* o, int BH, int T, int D, float sm_scale,
                                       cudaStream_t stream) {
  if (D == 64) return launch<64>(q, k, v, o, BH, T, sm_scale, stream);
  if (D == 128) return launch<128>(q, k, v, o, BH, T, sm_scale, stream);
  return (int)cudaErrorInvalidValue;
}
