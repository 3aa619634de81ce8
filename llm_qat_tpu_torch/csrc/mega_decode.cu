// Whole-model decode step, for sm_90a, in three attention variants.
//
// Replaces three Pallas kernels of llm_qat_tpu/ops/mega_decode.py:
//   `_mega_kernel_kv8` (per_slot=False) behind `mega_decode_step_kv8`:
//     int8 / int4 KV codes with row scales, one shared position (entry
//     point mega_decode_step_kv, attention kernel k_attn);
//   `_mega_kernel` behind `mega_decode_step`: a float32 or bf16
//     head-interleaved cache (mega_decode_step_f, k_attn_f);
//   `_mega_kernel_kv8` (per_slot=True) behind `mega_decode_step_cb`:
//     continuous batching, per-slot lengths over read-only main caches
//     plus a chunk-local recent buffer appended at a uniform rpos
//     (mega_decode_step_cb, k_attn with a recent block).
// Only the attention touches the caches, so the three share every other
// kernel (k_row, k_lora_a, k_gemv) and the host sequence (run_step). The
// Python wrappers are in llm_qat_tpu_torch/ops/mega_decode.py, each with a
// plain PyTorch version beside it that computes the same function.
//
// Bound. One token per sequence streams every weight it uses once: at
// GPT-2 124M with int4 tiles that is 12 layers x 12 tiles x (384 x 768)
// bytes = 42.5 MB, plus the LoRA tiles the step reads (int8: A tiles 0, 3,
// 4, 8-11 and B tiles 0-7, 11, 9.4 MB; the zero-padded 12-tile layout holds
// 14.2 MB), the scales, biases and LN vectors of those tiles (0.8 MB), and
// the KV prefix (per layer, sequence and row: 2 x d/2 code bytes + 2 x 4
// scale bytes, 74.5 KB per position at B = 8). At B = 8 the step is a GEMV,
// far below the card's operations-per-byte line, so it is bound by
// device-memory bytes (3.35 TB/s on an H100 SXM): 64.8 MB, 19.3 us, at
// pos 160. The float-cache step reads 2 x d x 2 bytes per bf16 cache row
// instead (95.2 MB, 28.4 us, at B = 8 and pos 143); the per-slot step reads
// each slot's own main prefix plus its recent rows.
//
// Design. The TPU kernel runs a sequential (layer, tile) grid and carries
// the hidden state between grid steps in VMEM; CUDA blocks run in no order,
// so the host function below walks the layers and launches per layer:
//   k_row  (LN1 + activation quantization) -> k_lora_a (LoRA-A)
//   k_gemv (qkv dot and its LoRA-B) -> k_row (qkv epilogue: scale, bias)
//   k_attn (quantize/append the new K/V row at pos, attention over [0,pos),
//           float32 merge of the new token)
//   k_row  (proj prep) -> k_gemv (proj) -> k_row (epilogue, residual, LN2,
//           prep of fc) -> k_gemv (fc) -> k_row (epilogue, A&S GELU, prep of
//           mlp over 4d) -> k_gemv (mlp, int32 over all 4d) -> k_row
//           (epilogue, residual, LN1 + prep of the next layer),
// each prologue followed by its k_lora_a.
// k_gemv reads each weight byte once with coalesced 32-bit loads and dp4a
// (s8 x s8 -> s32); the K dimension is split over `ksplit` blocks whose
// int32 partial sums the next k_row adds, so the integer dot is exact in any
// order. The same blocks split the LoRA-B rank and leave partial sums.
// k_row runs one 1024-thread block per batch row, as the LayerNorm needs
// the whole row; the LoRA-A that follows each prologue runs in its own
// kernel over (row, group of 8 outputs) blocks. Integer dots accumulate in
// int32, everything else in float32, as in the JAX kernel; the float sums
// run in another order than the plain version's, so the two differ by
// float32 rounding, which can flip an activation code at a rounding
// boundary. The step is 14 launches per layer. At B = 8 each launch moves
// under a megabyte: each kernel waits on short chains of dependent loads and
// block barriers, far from the byte bound (a persistent kernel that streams
// the weights over every SM is the later fix).
// Per slot, the TPU kernel streams every slot's main prefix up to the
// batch's longest and masks; here each (b, h) block stops at its own
// length, which gives the same result: a block that a row masks entirely
// adds exactly 0 once the row has a score, and before that its running max
// is -1e30, so the final correction exp(m - m_f) zeroes what it added.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)
#define N_TILES 12
#define ROW_THREADS 1024
#define GEMV_WARPS 4
#define GEMV_COLS 128  // 32 lanes x 4 columns
#define BCH 8          // batch rows per GEMV block
#define ATTN_THREADS 128
#define LB_SPLIT 4      // K-slices whose blocks also compute LoRA-B partials
#define MAX_SLOTS 256   // batch rows of a per-slot step (lengths passed by value)

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// ---------------------------------------------------------------------------
// numerics shared with the plain version
// ---------------------------------------------------------------------------

__device__ __forceinline__ float rt(float x, int act_bf16) {
  return act_bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// clamp(rne(x / s), -qmax, qmax)
__device__ __forceinline__ float q8f(float x, float s, float qmax) {
  return fminf(fmaxf(rintf(x / s), -qmax), qmax);
}

__device__ __forceinline__ float erf_as(float z) {
  float s = z > 0.f ? 1.f : (z < 0.f ? -1.f : 0.f);
  float za = fabsf(z);
  float t = 1.0f / (1.0f + 0.3275911f * za);
  float poly = ((((1.061405429f * t - 1.453152027f) * t + 1.421413741f) * t
                 - 0.284496736f) * t + 0.254829592f) * t;
  return s * (1.0f - poly * expf(-za * za));
}

__device__ __forceinline__ float gelu_as(float x) {
  return 0.5f * x * (1.0f + erf_as(x * 0.7071067811865476f));
}

// LoRA bank element as float: DT 0 float32, 1 bfloat16, 2 int8 codes
template <int DT>
__device__ __forceinline__ float bank_at(const void* p, size_t i) {
  if (DT == 0) return __ldg(static_cast<const float*>(p) + i);
  if (DT == 1) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return static_cast<float>(__ldg(static_cast<const int8_t*>(p) + i));
}

__device__ __forceinline__ float load_bank(const void* p, size_t i, int dt) {
  if (dt == 0) return bank_at<0>(p, i);
  if (dt == 1) return bank_at<1>(p, i);
  return bank_at<2>(p, i);
}

// 4 signed nibbles (low / high half of each byte) -> 4 sign-extended bytes
__device__ __forceinline__ int sext_lo(uint32_t w) {
  uint32_t x = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
  return static_cast<int>(__vsub4(x, 0x08080808u));
}
__device__ __forceinline__ int sext_hi(uint32_t w) {
  uint32_t x = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
  return static_cast<int>(__vsub4(x, 0x08080808u));
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide reductions; `red` holds 33 floats of shared memory.
__device__ __forceinline__ float block_sum(float v, float* red) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float x = lane < nw ? red[lane] : 0.f;
    x = warp_sum(x);
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  float r = red[32];
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nw = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float x = lane < nw ? red[lane] : NEG_INF;
    x = warp_max(x);
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  float r = red[32];
  __syncthreads();
  return r;
}

__device__ __forceinline__ float rd(float x, int lora_round) {
  return lora_round ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

// ---------------------------------------------------------------------------
// k_row: one block per batch row. Epilogue of one linear (sum of the int32
// K-slices, scale, bias, LoRA-B, then store / residual / GELU) and the
// prologue of the next (optional LN, quantization, LoRA-A).
// ---------------------------------------------------------------------------

struct RowArgs {
  // epilogue (part != nullptr)
  const int32_t* part;  // (ksplit, B, n_cols)
  int ksplit, n_cols, epi_tile0;
  const float* epi_xs;  // scalar on the device
  const float* ws;      // layer's (12, d)
  const float* bias;    // layer's (12, d)
  const float* plb;     // (LB_SPLIT, B, n_cols) LoRA-B partial sums
  const float* bt_s;    // layer's (12,)
  int finish;           // 0 store y, 1 residual into h, 2 GELU into y
  float* y;             // (B, n_cols)
  float* h;             // (B, d)
  // prologue
  const float* src;     // (B, K) input when there is no epilogue
  int prep;             // 0 none, 1 quantize, 2 LN then quantize
  int K;
  const float* ln_g;
  const float* ln_b;
  float eps;
  const float* prep_xs; // scalar on the device
  float aq;
  int8_t* qx;           // (B, K)
  float* xf;            // (B, K) the prepared row, input of k_lora_a
  // common
  int B, d, r, has_lora, lora_dt, lora_round, act_bf16;
};

__global__ void __launch_bounds__(ROW_THREADS) k_row(RowArgs a) {
  extern __shared__ float smf[];
  const int b = blockIdx.x, tid = threadIdx.x;
  float* red = smf;                       // 33 floats
  float* xrow = red + 33;                 // max(n_cols, K) floats

  if (a.part) {
    const float xs = *a.epi_xs;
    for (int n = tid; n < a.n_cols; n += blockDim.x) {
      const int tile = a.epi_tile0 + n / a.d, c = n % a.d;
      int acc = 0;
      for (int ks = 0; ks < a.ksplit; ++ks)
        acc += a.part[((size_t)ks * a.B + b) * a.n_cols + n];
      float y = (float)acc * (xs * a.ws[tile * a.d + c]) + a.bias[tile * a.d + c];
      if (a.has_lora) {
        float o = 0.f;
        for (int q = 0; q < LB_SPLIT; ++q) o += a.plb[((size_t)q * a.B + b) * a.n_cols + n];
        y = y + o * a.bt_s[tile];
      }
      if (a.finish == 0) {
        a.y[(size_t)b * a.n_cols + n] = y;
      } else if (a.finish == 1) {
        float hv = rt(a.h[b * a.d + n] + rt(y, a.act_bf16), a.act_bf16);
        a.h[b * a.d + n] = hv;
        xrow[n] = hv;
      } else {
        float gv = rt(gelu_as(y), a.act_bf16);
        a.y[(size_t)b * a.n_cols + n] = gv;
        xrow[n] = gv;
      }
    }
  } else if (a.prep) {
    for (int k = tid; k < a.K; k += blockDim.x) xrow[k] = a.src[(size_t)b * a.K + k];
  }
  if (!a.prep) return;
  __syncthreads();

  if (a.prep == 2) {  // LayerNorm over K == d
    float s = 0.f;
    for (int k = tid; k < a.K; k += blockDim.x) s += xrow[k];
    const float mean = block_sum(s, red) / (float)a.K;
    float v = 0.f;
    for (int k = tid; k < a.K; k += blockDim.x) {
      const float dx = xrow[k] - mean;
      v += dx * dx;
    }
    const float var = block_sum(v, red) / (float)a.K;
    const float rstd = 1.0f / sqrtf(var + a.eps);
    for (int k = tid; k < a.K; k += blockDim.x)
      xrow[k] = rt(a.ln_g[k] * (xrow[k] - mean) * rstd + a.ln_b[k], a.act_bf16);
    __syncthreads();
  }

  const float pxs = *a.prep_xs;
  for (int k = tid; k < a.K; k += blockDim.x) {
    a.qx[(size_t)b * a.K + k] = (int8_t)q8f(xrow[k], pxs, a.aq);
    if (a.has_lora) a.xf[(size_t)b * a.K + k] = xrow[k];
  }
}

// ---------------------------------------------------------------------------
// k_lora_a: block (b, output group) computes LoRA-A outputs j of row b,
// per d-wide chunk: partial sums over `nparts` slices of the chunk, reduced,
// times the tile scale; the chunk results are summed in order (the mlp's 4
// chunks, as the TPU kernel's 4 tiles).
// ---------------------------------------------------------------------------

#define LORA_THREADS 256

template <int DT>
__device__ float lora_a_dot(const float* xf, int K, int d, const void* at,
                            const float* at_s, int r, int j, int pidx, int nparts,
                            int jn, int lora_round, float* lp) {
  const int tid = threadIdx.x;
  const int per = (d + nparts - 1) / nparts;
  float xa_acc = 0.f;
  for (int ch = 0; ch < K / d; ++ch) {
    float s = 0.f;
    if (pidx < nparts) {
      const int k0 = pidx * per, k1 = min(d, k0 + per);
#pragma unroll 4
      for (int k = k0; k < k1; ++k) {
        const size_t ai = ((size_t)ch * d + k) * r + j;
        s += rd(xf[ch * d + k], lora_round) * rd(bank_at<DT>(at, ai), lora_round);
      }
    }
    lp[tid] = s;
    __syncthreads();
    if (tid < jn) {
      float td = 0.f;
      for (int p = 0; p < nparts; ++p) td += lp[p * jn + tid];
      const float t = td * at_s[ch];
      xa_acc = ch == 0 ? t : xa_acc + t;
    }
    __syncthreads();
  }
  return xa_acc;
}

__global__ void __launch_bounds__(LORA_THREADS)
k_lora_a(const float* __restrict__ xf, int K, int d, const void* at, const float* at_s,
         int r, int jn, int lora_dt, int lora_round, float* __restrict__ xa) {
  __shared__ float lp[LORA_THREADS];
  extern __shared__ float xs_row[];  // K floats
  const int b = blockIdx.x, tid = threadIdx.x;
  for (int k = tid; k < K; k += blockDim.x) xs_row[k] = xf[(size_t)b * K + k];
  __syncthreads();
  const int nparts = blockDim.x / jn;
  const int jj = tid % jn, pidx = tid / jn, j = blockIdx.y * jn + jj;
  float v;
  if (lora_dt == 0)
    v = lora_a_dot<0>(xs_row, K, d, at, at_s, r, j, pidx, nparts, jn, lora_round, lp);
  else if (lora_dt == 1)
    v = lora_a_dot<1>(xs_row, K, d, at, at_s, r, j, pidx, nparts, jn, lora_round, lp);
  else
    v = lora_a_dot<2>(xs_row, K, d, at, at_s, r, j, pidx, nparts, jn, lora_round, lp);
  if (tid < jn) xa[b * r + j] = v;
}

// ---------------------------------------------------------------------------
// k_gemv: partial s32 dots of the activation codes with int8 or per-tile
// K-halves int4 weight tiles, and the LoRA-B product of the same columns.
// Block (column group of 128, K-slice, batch chunk); each lane owns 4
// adjacent columns and reads 4 weight rows per step as 32-bit words (a warp
// reads 128 contiguous bytes per row). The K-slices' int32 partial sums go
// to `part`, which the next k_row adds; the first LB_SPLIT K-slices' blocks
// also split the LoRA-B rank and leave their partial sums in `plb`.
// ---------------------------------------------------------------------------

struct GemvArgs {
  const int8_t* qx;     // (B, K) activation codes
  int K;
  const uint8_t* wt;    // layer's first weight tile of this linear
  int d, dk, wbits, n_cols, n_in, B;
  int32_t* part;        // (ksplit, B, n_cols)
  // LoRA-B
  int has_lora, r, lora_dt, lora_round;
  const float* xa;      // (B, r) LoRA-A output
  const void* bt;       // layer's bank at the first B tile of this linear
  float* plb;           // (LB_SPLIT, B, n_cols)
};

template <int DT>
__device__ void lora_b_cols(const GemvArgs& a, const float* xas, int nb, int b0,
                            int to, int c, float* redf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float lb[BCH][4];
#pragma unroll
  for (int i = 0; i < BCH; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) lb[i][jj] = 0.f;
  for (int j = blockIdx.y * GEMV_WARPS + warp; j < a.r; j += LB_SPLIT * GEMV_WARPS) {
    float w[4];
    const size_t base = ((size_t)to * a.r + j) * a.d + c;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) w[jj] = rd(bank_at<DT>(a.bt, base + jj), a.lora_round);
#pragma unroll
    for (int i = 0; i < BCH; ++i) {
      if (i < nb) {
        const float x = xas[i * a.r + j];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) lb[i][jj] += x * w[jj];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < BCH; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      redf[(warp * BCH + i) * GEMV_COLS + lane * 4 + jj] = lb[i][jj];
  __syncthreads();
  for (int idx = threadIdx.x; idx < nb * GEMV_COLS; idx += blockDim.x) {
    const int i = idx / GEMV_COLS, cc = idx % GEMV_COLS;
    float sum = 0.f;
    for (int w2 = 0; w2 < GEMV_WARPS; ++w2) sum += redf[(w2 * BCH + i) * GEMV_COLS + cc];
    a.plb[((size_t)blockIdx.y * a.B + b0 + i) * a.n_cols + blockIdx.x * GEMV_COLS + cc] = sum;
  }
}

__global__ void __launch_bounds__(GEMV_WARPS * 32) k_gemv(GemvArgs a) {
  extern __shared__ float gsm[];
  float* redf = gsm;                                    // GEMV_WARPS*BCH*128
  int32_t* red = reinterpret_cast<int32_t*>(gsm);       // same space, int phase
  float* xas = redf + GEMV_WARPS * BCH * GEMV_COLS;                           // BCH*r
  int8_t* qs = reinterpret_cast<int8_t*>(xas + BCH * a.r);                    // BCH*K
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K = a.K, d = a.d, dk = a.dk;
  const int b0 = blockIdx.z * BCH;
  const int nb = min(BCH, a.B - b0);
  {
    const int words = K / 4;
    const int32_t* src = reinterpret_cast<const int32_t*>(a.qx);
    int32_t* dst = reinterpret_cast<int32_t*>(qs);
    for (int i = tid; i < nb * words; i += blockDim.x)
      dst[i] = src[(size_t)b0 * words + i];
    if (a.has_lora)
      for (int i = tid; i < nb * a.r; i += blockDim.x)
        xas[i] = rd(a.xa[(size_t)b0 * a.r + i], a.lora_round);
  }
  __syncthreads();

  const int col = blockIdx.x * GEMV_COLS + lane * 4;
  const int to = col / d, c = col % d;
  const int steps = a.n_in * dk / 4;
  const int nw = gridDim.y * GEMV_WARPS;
  int acc[BCH][4];
#pragma unroll
  for (int i = 0; i < BCH; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0;

#pragma unroll 2
  for (int s = blockIdx.y * GEMV_WARPS + warp; s < steps; s += nw) {
    const int kr = 4 * s, ki = kr / dk, kk = kr % dk;
    const uint8_t* base = a.wt + ((size_t)(to + ki) * dk + kk) * d + c;
    const uint32_t r0 = __ldg(reinterpret_cast<const uint32_t*>(base));
    const uint32_t r1 = __ldg(reinterpret_cast<const uint32_t*>(base + d));
    const uint32_t r2 = __ldg(reinterpret_cast<const uint32_t*>(base + 2 * d));
    const uint32_t r3 = __ldg(reinterpret_cast<const uint32_t*>(base + 3 * d));
    // 4x4 byte transpose: cw[j] = column j's bytes of rows kk..kk+3
    const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r0, r1, 0x7362);
    const uint32_t t2 = __byte_perm(r2, r3, 0x5140), t3 = __byte_perm(r2, r3, 0x7362);
    const uint32_t cw[4] = {__byte_perm(t0, t2, 0x5410), __byte_perm(t0, t2, 0x7632),
                            __byte_perm(t1, t3, 0x5410), __byte_perm(t1, t3, 0x7632)};
    if (a.wbits == 4) {
      int lo[4], hi[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) { lo[jj] = sext_lo(cw[jj]); hi[jj] = sext_hi(cw[jj]); }
#pragma unroll
      for (int i = 0; i < BCH; ++i) {
        if (i < nb) {
          const int alo = *reinterpret_cast<const int*>(qs + i * K + ki * d + kk);
          const int ahi = *reinterpret_cast<const int*>(qs + i * K + ki * d + d / 2 + kk);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            acc[i][jj] = __dp4a(alo, lo[jj], acc[i][jj]);
            acc[i][jj] = __dp4a(ahi, hi[jj], acc[i][jj]);
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < BCH; ++i) {
        if (i < nb) {
          const int av = *reinterpret_cast<const int*>(qs + i * K + ki * d + kk);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            acc[i][jj] = __dp4a(av, static_cast<int>(cw[jj]), acc[i][jj]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < BCH; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
      red[(warp * BCH + i) * GEMV_COLS + lane * 4 + jj] = acc[i][jj];
  __syncthreads();
  for (int idx = tid; idx < nb * GEMV_COLS; idx += blockDim.x) {
    const int i = idx / GEMV_COLS, cc = idx % GEMV_COLS;
    int sum = 0;
    for (int w = 0; w < GEMV_WARPS; ++w) sum += red[(w * BCH + i) * GEMV_COLS + cc];
    a.part[((size_t)blockIdx.y * a.B + b0 + i) * a.n_cols + blockIdx.x * GEMV_COLS + cc] = sum;
  }
  // LoRA-B of these columns: the first LB_SPLIT K-slices' blocks split the
  // rank and leave partial sums
  if (!a.has_lora || blockIdx.y >= LB_SPLIT) return;
  __syncthreads();  // the int reduction space is reused for the float sums
  if (a.lora_dt == 0) lora_b_cols<0>(a, xas, nb, b0, to, c, redf);
  else if (a.lora_dt == 1) lora_b_cols<1>(a, xas, nb, b0, to, c, redf);
  else lora_b_cols<2>(a, xas, nb, b0, to, c, redf);
}


// ---------------------------------------------------------------------------
// k_attn: one block per (b, h), int8 / int4 codes with per-row scales.
// Quantizes q per (b, h) row and the new K/V row per row (absmax over all d
// lanes), streams the cached rows [0, lens[b]) of the main caches in
// tbp-row blocks with s8 score and PV dots and probabilities quantized per
// block, then (continuous batching) the one recent block [0, rlim), merges
// the new token in float32 from its dequantized codes, and appends the new
// codes and scales at row `wpos` of the write target (the main caches at
// the shared position, or the recent buffer at rpos; a row never read here).
// ---------------------------------------------------------------------------

struct SlotLen {
  int v[MAX_SLOTS];
};

__device__ __forceinline__ int kv_word(const int8_t* row, int lane, int d2, int kv_bits) {
  // 4 codes of lanes [lane, lane+4) (lane % 4 == 0) as sign-extended bytes
  if (kv_bits == 8) return *reinterpret_cast<const int*>(row + lane);
  const uint32_t w = *reinterpret_cast<const uint32_t*>(row + (lane < d2 ? lane : lane - d2));
  return lane < d2 ? sext_lo(w) : sext_hi(w);
}

__device__ __forceinline__ int kv_code(const int8_t* row, int lane, int d2, int kv_bits) {
  if (kv_bits == 8) return row[lane];
  const int v = row[lane < d2 ? lane : lane - d2];
  return lane < d2 ? ((v << 28) >> 28) : (v >> 4);
}

struct AttnSmem {
  float* acc;      // D
  float* red;      // 33
  float* sb;       // tbp
  int* pvp;        // ATTN_THREADS
  int8_t* qcode;   // D
  int8_t* pq;      // tbp
};

// One tbp-row block [t0, t0 + tbp) of a batch row's cache (kb/vb codes,
// ksb/vsb scales), rows < lim valid: the online-softmax update of m, l, acc.
__device__ void attn_block_kv8(const int8_t* kb, const int8_t* vb, const float* ksb,
                               const float* vsb, int t0, int lim, int tbp, int h, int D,
                               int d2, int dc, int kv_bits, float qs, const AttnSmem& s,
                               float& m, float& l) {
  const int tid = threadIdx.x;
  const int lane_i = tid % D, npart = blockDim.x / D, part_i = tid / D;
  float lmax = NEG_INF;
  for (int t = tid; t < tbp; t += blockDim.x) {
    const int tt = t0 + t;
    float sv = NEG_INF;
    if (tt < lim) {
      const int8_t* row = kb + (size_t)tt * dc;
      int s32 = 0;
#pragma unroll 4
      for (int i4 = 0; i4 < D; i4 += 4)
        s32 = __dp4a(*reinterpret_cast<const int*>(s.qcode + i4),
                     kv_word(row, h * D + i4, d2, kv_bits), s32);
      sv = (float)s32 * qs * ksb[tt];
    }
    s.sb[t] = sv;
    lmax = fmaxf(lmax, sv);
  }
  const float m_new = fmaxf(m, block_max(lmax, s.red));
  const float corr = expf(m - m_new);
  float ls = 0.f;
  float lpm = 0.f;
  for (int t = tid; t < tbp; t += blockDim.x) {
    const float p = expf(s.sb[t] - m_new);
    ls += p;
    const float psc = (t0 + t < lim) ? p * vsb[t0 + t] : 0.f;
    s.sb[t] = psc;
    lpm = fmaxf(lpm, psc);
  }
  const float psum = block_sum(ls, s.red);
  l = l * corr + psum;
  const float ps = fmaxf(block_max(lpm, s.red), 1e-30f) / 127.f;
  for (int t = tid; t < tbp; t += blockDim.x) s.pq[t] = (int8_t)q8f(s.sb[t], ps, 127.f);
  __syncthreads();
  int pv = 0;
  if (part_i < npart) {
    const int tmax = min(tbp, lim - t0);
#pragma unroll 8
    for (int t = part_i; t < tmax; t += npart)
      pv += (int)s.pq[t] * kv_code(vb + (size_t)(t0 + t) * dc, h * D + lane_i, d2, kv_bits);
  }
  s.pvp[tid] = pv;
  __syncthreads();
  if (tid < D) {
    int tot = 0;
    for (int p = 0; p < npart; ++p) tot += s.pvp[p * D + tid];
    s.acc[tid] = s.acc[tid] * corr + (float)tot * ps;
  }
  m = m_new;
  __syncthreads();
}

// kc/vc/ksc/vsc: this layer's main caches (B, T, dc) / (B, T), rows
// [0, lens[b]) read; kr..vsr: this layer's recent buffer (B, Tr, dc) /
// (B, Tr), rows [0, rlim) read, or null; kw..vsw: the write target (B, Tw,
// dc) / (B, Tw), row wpos written.
__global__ void __launch_bounds__(ATTN_THREADS)
k_attn(const float* __restrict__ qkv, const int8_t* kc, const int8_t* vc, const float* ksc,
       const float* vsc, int T, SlotLen lens, const int8_t* kr, const int8_t* vr,
       const float* ksr, const float* vsr, int Tr, int rlim, int8_t* kw, int8_t* vw,
       float* ksw, float* vsw, int Tw, int wpos, float* __restrict__ attn, int H, int D,
       int d, int tbp, int kv_bits, float sm_scale, int act_bf16) {
  extern __shared__ float asmf[];
  float* qf = asmf;             // D
  float* vn = qf + D;           // D
  AttnSmem s;
  s.acc = vn + D;                                        // D
  s.red = s.acc + D;                                     // 33
  s.sb = s.red + 33;                                     // tbp
  s.pvp = reinterpret_cast<int*>(s.sb + tbp);            // ATTN_THREADS
  s.qcode = reinterpret_cast<int8_t*>(s.pvp + ATTN_THREADS);  // D
  s.pq = s.qcode + D;                                    // tbp

  const int b = blockIdx.x / H, h = blockIdx.x % H, tid = threadIdx.x;
  const int d2 = d / 2, dc = kv_bits == 8 ? d : d2;
  const float kvq = kv_bits == 8 ? 127.f : 7.f;
  const float* qrow = qkv + (size_t)b * 3 * d;
  const float* krow = qrow + d;
  const float* vrow = qrow + 2 * d;

  float qa = 0.f;
  for (int i = tid; i < D; i += blockDim.x) {
    const float v = qrow[h * D + i] * sm_scale;
    qf[i] = v;
    qa = fmaxf(qa, fabsf(v));
    s.acc[i] = 0.f;
  }
  const float qs = fmaxf(block_max(qa, s.red), 1e-8f) / 127.f;
  float ka = 0.f, va = 0.f;
  for (int i = tid; i < d; i += blockDim.x) {
    ka = fmaxf(ka, fabsf(krow[i]));
    va = fmaxf(va, fabsf(vrow[i]));
  }
  const float ks_new = fmaxf(block_max(ka, s.red), 1e-8f) / kvq;
  const float vs_new = fmaxf(block_max(va, s.red), 1e-8f) / kvq;
  float sn = 0.f;
  for (int i = tid; i < D; i += blockDim.x) {
    s.qcode[i] = (int8_t)q8f(qf[i], qs, 127.f);
    const float kn = q8f(krow[h * D + i], ks_new, kvq) * ks_new;
    vn[i] = q8f(vrow[h * D + i], vs_new, kvq) * vs_new;
    sn += qf[i] * kn;
  }
  const float s_new = block_sum(sn, s.red);  // syncs: qcode/vn visible

  float m = NEG_INF, l = 0.f;
  const int lim = lens.v[b];
  const int nblk = (lim + tbp - 1) / tbp;
  for (int j = 0; j < nblk; ++j)
    attn_block_kv8(kc + (size_t)b * T * dc, vc + (size_t)b * T * dc, ksc + (size_t)b * T,
                   vsc + (size_t)b * T, j * tbp, lim, tbp, h, D, d2, dc, kv_bits, qs, s, m, l);
  if (kr && rlim > 0)
    attn_block_kv8(kr + (size_t)b * Tr * dc, vr + (size_t)b * Tr * dc, ksr + (size_t)b * Tr,
                   vsr + (size_t)b * Tr, 0, rlim, tbp, h, D, d2, dc, kv_bits, qs, s, m, l);

  const float m_f = fmaxf(m, s_new);
  const float corr = expf(m - m_f);
  const float p_new = expf(s_new - m_f);
  const float l_f = l * corr + p_new;
  for (int i = tid; i < D; i += blockDim.x) {
    const float out = s.acc[i] * corr + p_new * vn[i];
    attn[(size_t)b * d + h * D + i] = rt(out / fmaxf(l_f, 1e-30f), act_bf16);
  }

  // append: this block writes the code bytes [h*D, (h+1)*D) ∩ [0, dc)
  int8_t* kwr = kw + ((size_t)b * Tw + wpos) * dc;
  int8_t* vwr = vw + ((size_t)b * Tw + wpos) * dc;
  const int j1 = min((h + 1) * D, dc);
  for (int jb = h * D + tid; jb < j1; jb += blockDim.x) {
    if (kv_bits == 8) {
      kwr[jb] = (int8_t)q8f(krow[jb], ks_new, kvq);
      vwr[jb] = (int8_t)q8f(vrow[jb], vs_new, kvq);
    } else {
      const int klo = (int)q8f(krow[jb], ks_new, kvq), khi = (int)q8f(krow[jb + d2], ks_new, kvq);
      const int vlo = (int)q8f(vrow[jb], vs_new, kvq), vhi = (int)q8f(vrow[jb + d2], vs_new, kvq);
      kwr[jb] = (int8_t)((klo & 0xF) | (khi << 4));
      vwr[jb] = (int8_t)((vlo & 0xF) | (vhi << 4));
    }
  }
  if (h == 0 && tid == 0) {
    ksw[(size_t)b * Tw + wpos] = ks_new;
    vsw[(size_t)b * Tw + wpos] = vs_new;
  }
}

// ---------------------------------------------------------------------------
// k_attn_f: one block per (b, h) over a float head-interleaved cache (T is
// float or bf16; replaces the attention of the Pallas `_mega_kernel`).
// q*sm_scale is rounded to the cache dtype for the score dots, each block's
// probabilities before the P.V sum, and the new K/V go through the cache
// dtype before their own score (against the unrounded q) and merge. Warps
// take whole rows for the scores (lanes over the head's D values), and the
// threads split rows x D lanes for P.V. The new K/V are appended at `pos`.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T> __device__ __forceinline__ float in_cdt(float x) {
  return to_f(from_f<T>(x));
}

template <typename T>
__global__ void __launch_bounds__(ATTN_THREADS)
k_attn_f(const float* __restrict__ qkv, T* kc, T* vc, float* __restrict__ attn, int H,
         int D, int d, int Tc, int pos, int tbp, float sm_scale, int act_bf16) {
  extern __shared__ float asmf[];
  float* qm = asmf;           // D
  float* acc = qm + D;        // D
  float* red = acc + D;       // 33
  float* sb = red + 33;       // tbp
  float* pvp = sb + tbp;      // ATTN_THREADS

  const int b = blockIdx.x / H, h = blockIdx.x % H, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nwarp = blockDim.x >> 5;
  const float* qrow = qkv + (size_t)b * 3 * d + h * D;
  const float* krow = qrow + d;
  const float* vrow = qrow + 2 * d;
  float sn = 0.f;
  for (int i = tid; i < D; i += blockDim.x) {
    const float q = qrow[i] * sm_scale;
    qm[i] = in_cdt<T>(q);
    acc[i] = 0.f;
    sn += q * in_cdt<T>(krow[i]);
  }
  const float s_new = block_sum(sn, red);  // syncs: qm/acc visible

  const T* kb = kc + (size_t)b * Tc * d + h * D;
  const T* vb = vc + (size_t)b * Tc * d + h * D;
  const int lane_i = tid % D, npart = blockDim.x / D, part_i = tid / D;
  float m = NEG_INF, l = 0.f;
  const int nblk = (pos + tbp - 1) / tbp;
  for (int j = 0; j < nblk; ++j) {
    const int t0 = j * tbp;
    for (int t = warp; t < tbp; t += nwarp) {
      const int tt = t0 + t;
      float part = 0.f;
      if (tt < pos)
        for (int i = lane; i < D; i += 32) part += qm[i] * to_f(kb[(size_t)tt * d + i]);
      part = warp_sum(part);
      if (lane == 0) sb[t] = tt < pos ? part : NEG_INF;
    }
    __syncthreads();
    float lmax = NEG_INF;
    for (int t = tid; t < tbp; t += blockDim.x) lmax = fmaxf(lmax, sb[t]);
    const float m_new = fmaxf(m, block_max(lmax, red));
    const float corr = expf(m - m_new);
    float ls = 0.f;
    for (int t = tid; t < tbp; t += blockDim.x) {
      const float p = expf(sb[t] - m_new);
      ls += p;
      sb[t] = in_cdt<T>(p);
    }
    l = l * corr + block_sum(ls, red);  // syncs: the rounded sb are visible
    float pv = 0.f;
    if (part_i < npart) {
      const int tmax = min(tbp, pos - t0);
      for (int t = part_i; t < tmax; t += npart)
        pv += sb[t] * to_f(vb[(size_t)(t0 + t) * d + lane_i]);
    }
    pvp[tid] = pv;
    __syncthreads();
    if (tid < D) {
      float tot = 0.f;
      for (int p = 0; p < npart; ++p) tot += pvp[p * D + tid];
      acc[tid] = acc[tid] * corr + tot;
    }
    m = m_new;
    __syncthreads();
  }

  const float m_f = fmaxf(m, s_new);
  const float corr = expf(m - m_f);
  const float p_new = expf(s_new - m_f);
  const float l_f = l * corr + p_new;
  for (int i = tid; i < D; i += blockDim.x) {
    const float out = acc[i] * corr + p_new * in_cdt<T>(vrow[i]);
    attn[(size_t)b * d + h * D + i] = rt(out / fmaxf(l_f, 1e-30f), act_bf16);
  }
  // append this head's lanes of row pos
  T* kw = kc + ((size_t)b * Tc + pos) * d + h * D;
  T* vw = vc + ((size_t)b * Tc + pos) * d + h * D;
  for (int i = tid; i < D; i += blockDim.x) {
    kw[i] = from_f<T>(krow[i]);
    vw[i] = from_f<T>(vrow[i]);
  }
}

// ---------------------------------------------------------------------------
// host side: one decode step on `stream`
// ---------------------------------------------------------------------------

// The attention of a step: which kernel, and the caches it reads and
// appends to.
struct Attn {
  int kind;      // 0 codes at a shared pos (#1), 1 float cache (#3), 2 per-slot (#4)
  int T, pos, tbp, kv_bits, cdt;
  void* kc;      // kind 0/2: (L, B, T, dc) int8 codes; kind 1: (L, B, T, d) float/bf16
  void* vc;
  float* ksc;    // kind 0/2: (L, B, T) row scales
  float* vsc;
  int8_t* kr;    // kind 2: the recent buffer (L, B, Tr, dc) + (L, B, Tr) scales
  int8_t* vr;
  float* ksr;
  float* vsr;
  int Tr, rpos;
  SlotLen lens;  // kinds 0/2: rows of the main caches each batch row reads
};

static int set_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

static int launch_attn(const Attn& A, int l, const float* qkv, float* attn, int B, int H,
                       int d, float sm_scale, int act_bf16, cudaStream_t stream) {
  const int D = d / H;
  int rc;
  if (A.kind == 1) {
    const size_t off = (size_t)l * B * A.T * d;
    const size_t smem = sizeof(float) * (2 * D + 33 + A.tbp + ATTN_THREADS);
    if (A.cdt == 0) {
      if ((rc = set_smem((const void*)k_attn_f<float>, smem))) return rc;
      k_attn_f<float><<<B * H, ATTN_THREADS, smem, stream>>>(
          qkv, static_cast<float*>(A.kc) + off, static_cast<float*>(A.vc) + off, attn, H, D,
          d, A.T, A.pos, A.tbp, sm_scale, act_bf16);
    } else {
      if ((rc = set_smem((const void*)k_attn_f<__nv_bfloat16>, smem))) return rc;
      k_attn_f<__nv_bfloat16><<<B * H, ATTN_THREADS, smem, stream>>>(
          qkv, static_cast<__nv_bfloat16*>(A.kc) + off, static_cast<__nv_bfloat16*>(A.vc) + off,
          attn, H, D, d, A.T, A.pos, A.tbp, sm_scale, act_bf16);
    }
    return (int)cudaGetLastError();
  }
  const int dc = A.kv_bits == 8 ? d : d / 2;
  const size_t lo = (size_t)l * B * A.T;
  int8_t* kc = static_cast<int8_t*>(A.kc) + lo * dc;
  int8_t* vc = static_cast<int8_t*>(A.vc) + lo * dc;
  float* ksc = A.ksc + lo;
  float* vsc = A.vsc + lo;
  const int8_t *kr = nullptr, *vr = nullptr;
  const float *ksr = nullptr, *vsr = nullptr;
  int8_t *kw = kc, *vw = vc;
  float *ksw = ksc, *vsw = vsc;
  int Tw = A.T, wpos = A.pos;
  if (A.kind == 2) {
    const size_t ro = (size_t)l * B * A.Tr;
    kw = A.kr + ro * dc; vw = A.vr + ro * dc; ksw = A.ksr + ro; vsw = A.vsr + ro;
    kr = kw; vr = vw; ksr = ksw; vsr = vsw;
    Tw = A.Tr; wpos = A.rpos;
  }
  const size_t smem = sizeof(float) * (3 * D + 33 + A.tbp)
                      + sizeof(int) * ATTN_THREADS + (size_t)D + A.tbp + 16;
  if ((rc = set_smem((const void*)k_attn, smem))) return rc;
  k_attn<<<B * H, ATTN_THREADS, smem, stream>>>(
      qkv, kc, vc, ksc, vsc, A.T, A.lens, kr, vr, ksr, vsr, A.Tr, A.rpos, kw, vw, ksw, vsw,
      Tw, wpos, attn, H, D, d, A.tbp, A.kv_bits, sm_scale, act_bf16);
  return (int)cudaGetLastError();
}

static int launch_row(const RowArgs& a, cudaStream_t stream) {
  const int xmax = a.part ? (a.n_cols > a.K ? a.n_cols : a.K) : a.K;
  const size_t smem = sizeof(float) * (33 + xmax);
  int rc = set_smem((const void*)k_row, smem);
  if (rc) return rc;
  k_row<<<a.B, ROW_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

static int launch_gemv(const GemvArgs& a, int ksplit, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (GEMV_WARPS * BCH * GEMV_COLS + BCH * a.r)
                      + (size_t)BCH * a.K;
  int rc = set_smem((const void*)k_gemv, smem);
  if (rc) return rc;
  dim3 grid(a.n_cols / GEMV_COLS, ksplit, (a.B + BCH - 1) / BCH);
  k_gemv<<<grid, GEMV_WARPS * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The weights, scratch and shape of a step (everything but its attention).
struct Step {
  const float* h_in; float* h_out; const int8_t* wt; const float* ws; const float* bias;
  const void* at; const void* bt; const float* at_s; const float* bt_s; const float* ln;
  const float* xs; int8_t* qx; float* xa; float* xf; int32_t* part; float* plb; float* qkv;
  float* attn; float* g;
  int L, B, d, H, r, wbits, has_lora, lora_dt, act_bf16, lora_round, ksplit;
  float eps, aq_max, sm_scale;
};

static int run_step(const Step& S, const Attn& A, cudaStream_t stream) {
  const int L = S.L, B = S.B, d = S.d, r = S.r, has_lora = S.has_lora;
  const int dk = S.wbits == 4 ? d / 2 : d;
  const size_t esz = S.lora_dt == 0 ? 4 : (S.lora_dt == 1 ? 2 : 1);
  float* h_out = S.h_out;
  int rc = (int)cudaMemcpyAsync(h_out, S.h_in, sizeof(float) * B * d,
                                cudaMemcpyDeviceToDevice, stream);
  if (rc) return rc;

  for (int l = 0; l < L; ++l) {
    const int8_t* wl = S.wt + (size_t)l * N_TILES * dk * d;
    const float* xsl = S.xs + l * 4;
    const char* btl = static_cast<const char*>(S.bt) + (size_t)l * N_TILES * r * d * esz;

    RowArgs base = {};
    base.B = B; base.d = d; base.r = r; base.has_lora = has_lora;
    base.lora_dt = S.lora_dt; base.lora_round = S.lora_round; base.act_bf16 = S.act_bf16;
    base.ws = S.ws + (size_t)l * N_TILES * d; base.bias = S.bias + (size_t)l * N_TILES * d;
    base.plb = S.plb; base.bt_s = S.bt_s + l * N_TILES;
    base.h = h_out; base.eps = S.eps; base.aq = S.aq_max; base.qx = S.qx; base.xf = S.xf;
    base.ksplit = S.ksplit;

    // prologue of a linear: LN (ln_off >= 0) or not, then quantization, of
    // layer `lp` (the next layer's for the mlp epilogue)
    auto prep_of = [&](RowArgs& a, int K, int ln_off, int lp, int xs_i) {
      a.prep = ln_off >= 0 ? 2 : 1; a.K = K;
      const float* lnp = S.ln + (size_t)lp * 4 * d;
      a.ln_g = lnp + (ln_off >= 0 ? ln_off : 0) * d;
      a.ln_b = lnp + (ln_off >= 0 ? ln_off + 1 : 1) * d;
      a.prep_xs = S.xs + lp * 4 + xs_i;
    };
    // k_row, then the LoRA-A of its prepared row from tile a_tile of layer lp
    auto row = [&](const RowArgs& a, int lp, int a_tile) {
      int e = launch_row(a, stream);
      if (e || !a.prep || !has_lora) return e;
      const int jn = r % 8 == 0 ? 8 : r;
      const void* atp = static_cast<const char*>(S.at)
                        + ((size_t)lp * N_TILES + a_tile) * d * r * esz;
      const size_t smem = sizeof(float) * a.K;
      if ((e = set_smem((const void*)k_lora_a, smem))) return e;
      k_lora_a<<<dim3(B, r / jn), LORA_THREADS, smem, stream>>>(
          S.xf, a.K, d, atp, S.at_s + lp * N_TILES + a_tile, r, jn, S.lora_dt, S.lora_round,
          S.xa);
      return (int)cudaGetLastError();
    };
    auto epi_of = [&](RowArgs& a, int n_cols, int tile0, int xs_i, int finish, float* y) {
      a.part = S.part; a.n_cols = n_cols; a.epi_tile0 = tile0; a.epi_xs = xsl + xs_i;
      a.finish = finish; a.y = y;
    };
    // GEMV of a linear: weight tiles from w_tile, LoRA-B tiles from b_tile
    auto gemv = [&](int K, int w_tile, int n_cols, int n_in, int b_tile) {
      GemvArgs ga = {};
      ga.qx = S.qx; ga.K = K;
      ga.wt = reinterpret_cast<const uint8_t*>(wl + (size_t)w_tile * dk * d);
      ga.d = d; ga.dk = dk; ga.wbits = S.wbits; ga.n_cols = n_cols; ga.n_in = n_in; ga.B = B;
      ga.part = S.part; ga.has_lora = has_lora; ga.r = r; ga.lora_dt = S.lora_dt;
      ga.lora_round = S.lora_round; ga.xa = S.xa; ga.bt = btl + (size_t)b_tile * r * d * esz;
      ga.plb = S.plb;
      return launch_gemv(ga, S.ksplit, stream);
    };

    if (l == 0) {  // LN1 + qkv prologue of the first layer
      RowArgs a = base;
      a.src = h_out;
      prep_of(a, d, 0, 0, 0);
      if ((rc = row(a, 0, 0))) return rc;
    }
    // qkv: 3 out-tiles, epilogue stores the float32 row
    if ((rc = gemv(d, 0, 3 * d, 1, 0))) return rc;
    { RowArgs a = base; epi_of(a, 3 * d, 0, 0, 0, S.qkv);
      if ((rc = row(a, l, 0))) return rc; }
    // attention + append
    if ((rc = launch_attn(A, l, S.qkv, S.attn, B, S.H, d, S.sm_scale, S.act_bf16, stream)))
      return rc;
    // proj prologue, GEMV, epilogue + residual + LN2 + fc prologue
    { RowArgs a = base; a.src = S.attn; prep_of(a, d, -1, l, 1);
      if ((rc = row(a, l, 3))) return rc; }
    if ((rc = gemv(d, 3, d, 1, 3))) return rc;
    { RowArgs a = base; epi_of(a, d, 3, 1, 1, nullptr); prep_of(a, d, 2, l, 2);
      if ((rc = row(a, l, 4))) return rc; }
    // fc, epilogue + GELU + mlp prologue over 4d
    if ((rc = gemv(d, 4, 4 * d, 1, 4))) return rc;
    { RowArgs a = base; epi_of(a, 4 * d, 4, 2, 2, S.g); prep_of(a, 4 * d, -1, l, 3);
      if ((rc = row(a, l, 8))) return rc; }
    // mlp over 4 row tiles (int32 over all 4d), epilogue + residual, then
    // the next layer's LN1 + qkv prologue
    if ((rc = gemv(4 * d, 8, d, 4, 11))) return rc;
    {
      RowArgs a = base;
      epi_of(a, d, 11, 3, 1, nullptr);
      if (l + 1 < L) prep_of(a, d, 0, l + 1, 0);
      if ((rc = row(a, l + 1, 0))) return rc;
    }
  }
  return 0;
}

#define STEP_ARGS                                                                          \
  const float *h_in, float *h_out, const int8_t *wt, const float *ws, const float *bias,  \
      const void *at, const void *bt, const float *at_s, const float *bt_s,                 \
      const float *ln, const float *xs
#define SCRATCH_ARGS                                                                      \
  int8_t *qx, float *xa, float *xf, int32_t *part, float *plb, float *qkv, float *attn,   \
      float *g

static Step make_step(STEP_ARGS, SCRATCH_ARGS, int L, int B, int d, int H, int r, int wbits,
                      int has_lora, int lora_dt, int act_bf16, int lora_round, int ksplit,
                      float eps, float aq_max, float sm_scale) {
  Step S = {h_in, h_out, wt, ws, bias, at, bt, at_s, bt_s, ln, xs, qx, xa, xf, part, plb,
            qkv, attn, g, L, B, d, H, r, wbits, has_lora, lora_dt, act_bf16, lora_round,
            ksplit, eps, aq_max, sm_scale};
  return S;
}

// #1: int8 / int4 codes + (L, B, T) row scales, appended at the shared pos.
extern "C" int mega_decode_step_kv(
    STEP_ARGS, int8_t* kc, int8_t* vc, float* ksc, float* vsc, SCRATCH_ARGS, int L, int B,
    int d, int H, int T, int r, int pos, int tbp, int wbits, int kv_bits, int has_lora,
    int lora_dt, int act_bf16, int lora_round, int ksplit, float eps, float aq_max,
    float sm_scale, cudaStream_t stream) {
  if (B > MAX_SLOTS) return (int)cudaErrorInvalidValue;
  Attn A = {};
  A.kind = 0; A.T = T; A.pos = pos; A.tbp = tbp; A.kv_bits = kv_bits;
  A.kc = kc; A.vc = vc; A.ksc = ksc; A.vsc = vsc;
  for (int b = 0; b < B; ++b) A.lens.v[b] = pos;
  return run_step(make_step(h_in, h_out, wt, ws, bias, at, bt, at_s, bt_s, ln, xs, qx, xa,
                            xf, part, plb, qkv, attn, g, L, B, d, H, r, wbits, has_lora,
                            lora_dt, act_bf16, lora_round, ksplit, eps, aq_max, sm_scale),
                  A, stream);
}

// #3: float head-interleaved (L, B, T, d) caches (cdt 0 float32, 1 bf16),
// appended at the shared pos.
extern "C" int mega_decode_step_f(
    STEP_ARGS, void* kc, void* vc, SCRATCH_ARGS, int L, int B, int d, int H, int T, int r,
    int pos, int tbp, int wbits, int cdt, int has_lora, int lora_dt, int act_bf16,
    int lora_round, int ksplit, float eps, float aq_max, float sm_scale,
    cudaStream_t stream) {
  Attn A = {};
  A.kind = 1; A.T = T; A.pos = pos; A.tbp = tbp; A.cdt = cdt; A.kc = kc; A.vc = vc;
  return run_step(make_step(h_in, h_out, wt, ws, bias, at, bt, at_s, bt_s, ln, xs, qx, xa,
                            xf, part, plb, qkv, attn, g, L, B, d, H, r, wbits, has_lora,
                            lora_dt, act_bf16, lora_round, ksplit, eps, aq_max, sm_scale),
                  A, stream);
}

// #4: per-slot main lengths (lens_host: B ints in host memory, copied into
// the launch's arguments) over read-only main caches (L, B, T, dc) + (L, B,
// T), then the recent buffer (L, B, Tr, dc) + (L, B, Tr) rows [0, rpos),
// which receives the new codes and scales at rpos.
extern "C" int mega_decode_step_cb(
    STEP_ARGS, int8_t* kc, int8_t* vc, float* ksc, float* vsc, int8_t* kr, int8_t* vr,
    float* ksr, float* vsr, const int* lens_host, SCRATCH_ARGS, int L, int B, int d, int H,
    int T, int Tr, int r, int rpos, int tbp, int wbits, int kv_bits, int has_lora,
    int lora_dt, int act_bf16, int lora_round, int ksplit, float eps, float aq_max,
    float sm_scale, cudaStream_t stream) {
  if (B > MAX_SLOTS) return (int)cudaErrorInvalidValue;
  Attn A = {};
  A.kind = 2; A.T = T; A.pos = 0; A.tbp = tbp; A.kv_bits = kv_bits;
  A.kc = kc; A.vc = vc; A.ksc = ksc; A.vsc = vsc;
  A.kr = kr; A.vr = vr; A.ksr = ksr; A.vsr = vsr; A.Tr = Tr; A.rpos = rpos;
  for (int b = 0; b < B; ++b) A.lens.v[b] = lens_host[b];
  return run_step(make_step(h_in, h_out, wt, ws, bias, at, bt, at_s, bt_s, ln, xs, qx, xa,
                            xf, part, plb, qkv, attn, g, L, B, d, H, r, wbits, has_lora,
                            lora_dt, act_bf16, lora_round, ksplit, eps, aq_max, sm_scale),
                  A, stream);
}
