// One-token decode attention over packed KV caches, with in-place append,
// for sm_90a.
//
// Replaces two Pallas kernels of llm_qat_tpu/ops/decode_attention.py:
// `_hbm_kernel` behind `decode_attention_hbm` (one shared position) and
// `_hbm_kernel_multi` behind `decode_attention_hbm_multi` (a position per
// slot, -1 = inactive). One kernel serves both: it takes a position per
// slot, and the shared-position wrapper passes the same position for every
// slot. The Python wrappers are in llm_qat_tpu_torch/ops/decode_attention.py,
// with their plain PyTorch versions beside them.
//
// Layout. A cache is (B, H, T/P, 128) in float32 or bf16: packed row u holds
// timesteps P*u .. P*u + P - 1 in lane groups of D = 128 / P lanes.
//
// Bound. Per (b, h) the kernel reads its q, the live prefix [0, pos) of K
// and V once (2 x ceil(pos / P) x 128 cache elements) and writes D output
// floats and one lane group of K and V. At B = 8, H = 12 and pos 512 in bf16
// that is 12.6 MB: about 3.8 us at 3.35 TB/s. Its operations (4 x D per
// timestep) are far below the card's operations-per-byte line, so it is
// bound by device-memory bytes.
//
// Design. One 128-thread block per (b, h); blocks run in no order, and each
// streams its own prefix, stopping at its own position (the TPU kernel
// streams every slot up to the batch's largest position and masks; a block
// that a slot masks entirely adds exactly 0 there, so the result is the
// same). Per block of `tbp` packed rows: each warp takes whole rows, each
// lane 4 of the 128 lanes, and a shuffle reduction over the D/4 lanes of a
// lane group gives the P scores of the row (q*sm_scale rounded to the cache
// dtype, as the TPU kernel's Qm). The block's maximum is taken over both
// lane groups; its probabilities are rounded to the cache dtype before the
// P.V sum; thread c accumulates lane c of the weighted V row, which is
// output lane c % D of lane group c / D, and the groups are added in order
// at the end. The new token's K/V go through the cache dtype and merge last
// (its score against the unrounded float32 q), and the append writes only
// the lane group of row pos / P that belongs to pos, after the block's last
// read. Scores, sums and the softmax are float32; bf16 x bf16 products are
// exact in float32, so the kernel and its plain version differ by the order
// of float32 sums only.
//
// A second kernel, `k_decode_dense` (entry `decode_attention_dense`),
// replaces the Pallas `_decode_attn_kernel` behind `decode_attention`
// (kernel #9): the same one-token attention on dense (B, H, T, D) caches,
// with a position per slot (a shared one is broadcast). The TPU kernel
// writes the new row at pos in the cache dtype, then takes float32 scores
// of q*sm_scale (not rounded) against every row, masks rows past pos, and
// runs one exact softmax whose probabilities stay float32. Here one
// 128-thread block per (b, h) writes the new row first (so the rows it
// reads back are rounded to the cache dtype, as in the TPU kernel), then
// one warp per row computes the scores of rows 0 .. pos into shared memory
// (a masked row adds exactly 0 to the TPU kernel's sums once row pos has a
// score, so the block stops at its own pos), takes the block maximum and
// the float32 probabilities, and thread c sums P.V for lane c % D over
// every (128 / D)-th row; the partial sums are added in a fixed order. It
// reads the live prefix of K and V once (2 (pos + 1) D cache elements per
// (b, h)): bound by device-memory bytes, like #7/#8.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF (-1e30f)
#define MAX_SLOTS 256
#define THREADS 128
#define ROW 128  // lanes of a packed row (P * D)

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

struct SlotPos {
  int v[MAX_SLOTS];
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to the cache dtype, as float
template <typename T> __device__ __forceinline__ float in_cdt(float x) {
  return to_f(from_f<T>(x));
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
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float x = lane < THREADS / 32 ? red[lane] : 0.f;
    x = warp_sum(x);
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  const float r = red[32];
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float x = lane < THREADS / 32 ? red[lane] : NEG_INF;
    x = warp_max(x);
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  const float r = red[32];
  __syncthreads();
  return r;
}

// q, kn, vn: (B*H, D) float32; kc, vc: (B*H, Tp, ROW) of T; out (B*H, D).
template <typename T>
__global__ void __launch_bounds__(THREADS)
k_decode_hbm(const float* __restrict__ q, const float* __restrict__ kn,
             const float* __restrict__ vn, T* kc, T* vc, float* __restrict__ out,
             SlotPos pos, int H, int D, int Tp, int P, int tbp, float sm_scale) {
  extern __shared__ float sm[];
  float* sc = sm;              // tbp * P scores, then rounded probabilities
  float* red = sc + tbp * P;   // 33
  __shared__ float qm[ROW];    // q*sm_scale in the cache dtype, per lane
  __shared__ float accs[ROW];

  const int bh = blockIdx.x, b = bh / H, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int p = pos.v[b];
  const float* qrow = q + (size_t)bh * D;
  for (int c = tid; c < ROW; c += THREADS) qm[c] = in_cdt<T>(qrow[c % D] * sm_scale);
  __syncthreads();

  const T* kb = kc + (size_t)bh * Tp * ROW;
  const T* vb = vc + (size_t)bh * Tp * ROW;
  const int gl = D / 4;         // lanes of a warp per lane group
  const int g = tid / D;        // lane group of this thread's output lane
  const int live = p > 0 ? p : 0;
  const int nblk = (live + P * tbp - 1) / (P * tbp);
  float m = NEG_INF, l = 0.f, acc = 0.f;
  for (int j = 0; j < nblk; ++j) {
    const int u0 = j * tbp;
    for (int u = warp; u < tbp; u += THREADS / 32) {
      const T* row = kb + (size_t)(u0 + u) * ROW + 4 * lane;
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) part += qm[4 * lane + e] * to_f(row[e]);
      for (int o = gl / 2; o > 0; o >>= 1) part += __shfl_xor_sync(0xffffffffu, part, o);
      if (lane % gl == 0) {
        const int i = lane / gl;
        sc[u * P + i] = (u0 + u) * P + i < p ? part : NEG_INF;
      }
    }
    __syncthreads();
    float lmax = NEG_INF;
    for (int x = tid; x < tbp * P; x += THREADS) lmax = fmaxf(lmax, sc[x]);
    const float m_new = fmaxf(m, block_max(lmax, red));
    const float corr = expf(m - m_new);
    float ls = 0.f;
    for (int x = tid; x < tbp * P; x += THREADS) {
      const float pr = expf(sc[x] - m_new);
      ls += pr;
      sc[x] = in_cdt<T>(pr);
    }
    l = l * corr + block_sum(ls, red);  // syncs: the rounded sc are visible
    float pv = 0.f;
    for (int u = 0; u < tbp; ++u)
      pv += sc[u * P + g] * to_f(vb[(size_t)(u0 + u) * ROW + tid]);
    acc = acc * corr + pv;
    m = m_new;
    __syncthreads();  // the next block overwrites sc
  }

  accs[tid] = acc;
  float sn = 0.f;
  for (int i = tid; i < D; i += THREADS)
    sn += qrow[i] * sm_scale * in_cdt<T>(kn[(size_t)bh * D + i]);
  const float s_new = block_sum(sn, red);  // syncs: accs visible
  const float m_f = fmaxf(m, s_new);
  const float corr = expf(m - m_f);
  const float p_new = expf(s_new - m_f);
  const float l_f = l * corr + p_new;
  for (int i = tid; i < D; i += THREADS) {
    float o = accs[i];
    for (int grp = 1; grp < P; ++grp) o += accs[grp * D + i];
    o = o * corr + p_new * in_cdt<T>(vn[(size_t)bh * D + i]);
    out[(size_t)bh * D + i] = o / fmaxf(l_f, 1e-30f);
  }
  if (p < 0) return;  // inactive slot: no append
  const size_t w = ((size_t)bh * Tp + p / P) * ROW + (p % P) * D;
  for (int i = tid; i < D; i += THREADS) {
    kc[w + i] = from_f<T>(kn[(size_t)bh * D + i]);
    vc[w + i] = from_f<T>(vn[(size_t)bh * D + i]);
  }
}

// q, kn, vn: (B*H, D) float32; kc, vc: (B*H, Tn, D) of T; out (B*H, D).
// 0 <= pos < Tn for every slot; D is 32, 64 or 128.
template <typename T>
__global__ void __launch_bounds__(THREADS)
k_decode_dense(const float* __restrict__ q, const float* __restrict__ kn,
               const float* __restrict__ vn, T* kc, T* vc, float* __restrict__ out,
               SlotPos pos, int H, int D, int Tn, float sm_scale) {
  extern __shared__ float sm[];
  float* sc = sm;             // Tn scores, then probabilities (rows 0 .. pos)
  float* red = sc + Tn;       // 33
  float* part = red + 33;     // THREADS partial P.V sums
  __shared__ float qs[THREADS];

  const int bh = blockIdx.x, b = bh / H, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int p = pos.v[b];
  T* kb = kc + (size_t)bh * Tn * D;
  T* vb = vc + (size_t)bh * Tn * D;
  for (int i = tid; i < D; i += THREADS) {
    kb[(size_t)p * D + i] = from_f<T>(kn[(size_t)bh * D + i]);
    vb[(size_t)p * D + i] = from_f<T>(vn[(size_t)bh * D + i]);
    qs[i] = q[(size_t)bh * D + i] * sm_scale;
  }
  __syncthreads();  // the new row is read back below

  for (int t = warp; t <= p; t += THREADS / 32) {
    const T* row = kb + (size_t)t * D;
    float s = 0.f;
    for (int e = lane; e < D; e += 32) s += qs[e] * to_f(row[e]);
    s = warp_sum(s);
    if (lane == 0) sc[t] = s;
  }
  __syncthreads();
  float lmax = NEG_INF;
  for (int t = tid; t <= p; t += THREADS) lmax = fmaxf(lmax, sc[t]);
  const float m = block_max(lmax, red);
  float ls = 0.f;
  for (int t = tid; t <= p; t += THREADS) {
    const float e = expf(sc[t] - m);
    sc[t] = e;
    ls += e;
  }
  const float l = block_sum(ls, red);  // syncs: the probabilities are visible

  const int groups = THREADS / D, d = tid % D;
  float acc = 0.f;
  for (int t = tid / D; t <= p; t += groups) acc += sc[t] * to_f(vb[(size_t)t * D + d]);
  part[tid] = acc;
  __syncthreads();
  if (tid < D) {
    float o = part[tid];
    for (int gi = 1; gi < groups; ++gi) o += part[gi * D + tid];
    out[(size_t)bh * D + tid] = o / fmaxf(l, 1e-30f);
  }
}

// #9: pos_host as for decode_attention_hbm, each 0 <= pos < T.
extern "C" int decode_attention_dense(const float* q, const float* kn, const float* vn,
                                      void* kc, void* vc, float* out, const int* pos_host,
                                      int B, int H, int D, int T, int cdt, float sm_scale,
                                      cudaStream_t stream) {
  if (B > MAX_SLOTS || D % 32 || THREADS % D) return (int)cudaErrorInvalidValue;
  SlotPos sp;
  for (int b = 0; b < B; ++b) {
    if (pos_host[b] < 0 || pos_host[b] >= T) return (int)cudaErrorInvalidValue;
    sp.v[b] = pos_host[b];
  }
  const size_t smem = sizeof(float) * (T + 33 + THREADS);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  if (cdt == 0)
    k_decode_dense<float><<<B * H, THREADS, smem, stream>>>(
        q, kn, vn, static_cast<float*>(kc), static_cast<float*>(vc), out, sp, H, D, T,
        sm_scale);
  else
    k_decode_dense<__nv_bfloat16><<<B * H, THREADS, smem, stream>>>(
        q, kn, vn, static_cast<__nv_bfloat16*>(kc), static_cast<__nv_bfloat16*>(vc), out, sp,
        H, D, T, sm_scale);
  return (int)cudaGetLastError();
}

// pos_host: B positions in host memory, copied into the launch's arguments
// (no device copy, no host sync). cdt 0 float32, 1 bfloat16.
extern "C" int decode_attention_hbm(const float* q, const float* kn, const float* vn,
                                    void* kc, void* vc, float* out, const int* pos_host,
                                    int B, int H, int D, int Tp, int P, int tbp, int cdt,
                                    float sm_scale, cudaStream_t stream) {
  if (B > MAX_SLOTS || P * D != ROW || D % 4) return (int)cudaErrorInvalidValue;
  SlotPos sp;
  for (int b = 0; b < B; ++b) sp.v[b] = pos_host[b];
  const size_t smem = sizeof(float) * (tbp * P + 33);
  if (cdt == 0)
    k_decode_hbm<float><<<B * H, THREADS, smem, stream>>>(
        q, kn, vn, static_cast<float*>(kc), static_cast<float*>(vc), out, sp, H, D, Tp,
        P, tbp, sm_scale);
  else
    k_decode_hbm<__nv_bfloat16><<<B * H, THREADS, smem, stream>>>(
        q, kn, vn, static_cast<__nv_bfloat16*>(kc), static_cast<__nv_bfloat16*>(vc), out,
        sp, H, D, Tp, P, tbp, sm_scale);
  return (int)cudaGetLastError();
}
