// The fused int8 decode layer for sm_90a: LN1 + QKV, and everything after
// the attention (proj, residual, LN2, fc, GELU, mlp, residual).
//
// Replaces two Pallas kernels of llm_qat_tpu/ops/fused_decode.py:
// - `_qkv_kernel` (called by `fused_ln_qkv`, kernel #12) with the entry
//   `fused_ln_qkv`:  hn = LN1(h); qkv = i8dot(q8(hn)) + LoRA(hn);
// - `_post_kernel` (called by `fused_post_attention`, kernel #13) with the
//   entry `fused_post_attention`:
//     h1 = h + i8dot(q8(attn)) + LoRA(attn);  hn = LN2(h1);
//     g = GELU(i8dot(q8(hn)) + LoRA(hn));      out = h1 + i8dot(q8(g)) + LoRA(g)
// where q8(x) = clamp(rne(x / xs), +-127) with a static activation scale xs,
// i8dot(qx) = float(qx . w_i8) * (xs * ws[n]) + b[n] with an exact int32
// dot, and LoRA(x) = bank(bank(x) . A) . B with float32 sums (bank(): the
// LoRA bank's dtype, bf16 or float32). The Python wrappers are
// llm_qat_tpu_torch/ops/fused_decode.py::fused_ln_qkv and
// ::fused_post_attention, with their plain PyTorch versions beside them.
//
// Every float32 step follows the JAX kernel's order, each rounded on its
// own as PyTorch's elementwise ops are: IEEE division in q8 and LN (not a
// reciprocal), rintf (round half to even), xs * ws formed first and then
// acc * (xs * ws) + b, the A&S 7.1.26 erf of the JAX `_erf` (not erff), and
// the __fmul_rn/__fadd_rn intrinsics wherever a product feeds a sum, so
// that nvcc contracts nothing into an FMA. LN's rsqrt is rsqrtf, which is
// what torch.rsqrt runs on the card. The int8 dots are exact (__dp4a in
// int32), so the kernels and their plain versions differ only where the
// float32 sums of LN and LoRA are taken in another order; such a difference
// moves an activation code now and then, when a value sits on a rounding
// boundary of q8.
//
// Design. The TPU kernels are one grid-less program each; here each entry
// is a short sequence of launches on PyTorch's stream:
// - `k_ln`: one block per batch row (LN statistics need the whole row);
// - `k_lin_a`: one linear's GEMV spread over the card. Blocks x < ncg take
//   256 columns each (64 threads x 4 columns, 4 lanes of K rows) of one
//   chunk of K rows (the chunk halved from 64 down to 16 until there are
//   132 blocks or more): they quantize their chunk of x in shared memory,
//   read four rows of four columns of codes as four 32-bit words, transpose
//   them with byte_perm and take __dp4a with the packed activation codes,
//   then add their int32 sums into an int32 accumulator with atomics (exact,
//   so the order does not matter; the accumulator is zeroed first). One
//   more block per chunk (x = ncg) takes that chunk's LoRA-A partial sums
//   (bank(x) . A over the chunk) into a float32 workspace;
// - `k_lin_b`: one thread per output column: sums the LoRA-A partials over
//   the chunks in a fixed order (deterministic), rounds them to the bank
//   dtype, and forms acc * (xs * ws) + b + LoRA-B, then the residual add or
//   the GELU of its place in the layer.
// #12 is k_ln, k_lin_a, k_lin_b; #13 is (k_lin_a, k_lin_b) for proj, k_ln,
// then (k_lin_a, k_lin_b) for fc and for mlp.
//
// Bound. The layer must read its int8 weights (12 d^2 bytes: 7.1 MB at
// d = 768), the LoRA banks, scales and biases, and the activations: at
// decode batch sizes it is bound by device-memory bytes (about 2.2 us per
// layer at 3.35 TB/s at GPT-2 124M width, rank 64 bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NT 256      // threads per block
#define COLS 256    // columns per GEMV block
#define KCH 64      // the largest chunk of K rows per block
#define MAXB 16     // batch rows
#define MAXR 64     // LoRA rank
#define MIN_BLOCKS 132

extern "C" const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// x rounded to the LoRA bank's dtype
template <typename T> __device__ __forceinline__ float in_bank(float x);
template <> __device__ __forceinline__ float in_bank<float>(float x) { return x; }
template <> __device__ __forceinline__ float in_bank<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float q8(float x, float xs) {
  return fminf(fmaxf(rintf(__fdiv_rn(x, xs)), -127.f), 127.f);
}

// Abramowitz & Stegun 7.1.26, as the JAX `_erf`
__device__ __forceinline__ float erf_as(float z) {
  const float s = z > 0.f ? 1.f : (z < 0.f ? -1.f : 0.f);
  const float za = fabsf(z);
  const float t = __fdiv_rn(1.f, __fadd_rn(1.f, __fmul_rn(0.3275911f, za)));
  float poly = __fmul_rn(1.061405429f, t);
  poly = __fmul_rn(__fsub_rn(poly, 1.453152027f), t);
  poly = __fmul_rn(__fadd_rn(poly, 1.421413741f), t);
  poly = __fmul_rn(__fsub_rn(poly, 0.284496736f), t);
  poly = __fmul_rn(__fadd_rn(poly, 0.254829592f), t);
  return __fmul_rn(s, __fsub_rn(1.f, __fmul_rn(poly, expf(__fmul_rn(-za, za)))));
}

__device__ __forceinline__ float gelu(float x) {
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.f, erf_as(__fmul_rn(x, 0.70710678118654752f))));
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float x = lane < NT / 32 ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    if (lane == 0) red[32] = x;
  }
  __syncthreads();
  const float r = red[32];
  __syncthreads();
  return r;
}

// y[row] = g * (x - mean) * rsqrt(var + eps) + b over one row of d.
__global__ void __launch_bounds__(NT)
k_ln(const float* __restrict__ x, const float* __restrict__ g, const float* __restrict__ b,
     float* __restrict__ y, int d, float eps) {
  __shared__ float red[33];
  const float* xr = x + (size_t)blockIdx.x * d;
  float s = 0.f;
  for (int i = threadIdx.x; i < d; i += NT) s = __fadd_rn(s, xr[i]);
  const float mean = __fdiv_rn(block_sum(s, red), (float)d);
  float v = 0.f;
  for (int i = threadIdx.x; i < d; i += NT) {
    const float dl = __fsub_rn(xr[i], mean);
    v = __fadd_rn(v, __fmul_rn(dl, dl));
  }
  const float rs = rsqrtf(__fadd_rn(__fdiv_rn(block_sum(v, red), (float)d), eps));
  float* yr = y + (size_t)blockIdx.x * d;
  for (int i = threadIdx.x; i < d; i += NT)
    yr[i] = __fadd_rn(__fmul_rn(__fmul_rn(g[i], __fsub_rn(xr[i], mean)), rs), b[i]);
}

// The codes of rows k .. k+3 and columns n .. n+3 (four row words) as four
// column words, row k in the low byte.
__device__ __forceinline__ void transpose4(const int* r, int* c) {
  const int t0 = __byte_perm(r[0], r[1], 0x5140), t1 = __byte_perm(r[2], r[3], 0x5140);
  const int t2 = __byte_perm(r[0], r[1], 0x7362), t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

// One linear's GEMV (blocks x < ncg) and LoRA-A partials (block x = ncg)
// over chunk y of kch rows. x (B, K) float32; w (K, N) int8; la (K, r).
// acc (B, N) int32 += q8(x) . w; part[y] (B, r) = bank(x) . la over the chunk.
template <typename TB>
__global__ void __launch_bounds__(NT)
k_lin_a(const float* __restrict__ x, const float* __restrict__ xs_ptr,
        const int8_t* __restrict__ w, const TB* __restrict__ la, int* __restrict__ acc,
        float* __restrict__ part, int B, int K, int N, int r, int ncg, int kch) {
  __shared__ __align__(16) int8_t xq[MAXB * KCH];
  __shared__ float xr[MAXB * KCH];
  __shared__ int sacc[MAXB * COLS];
  __shared__ float red[4 * MAXB * MAXR];
  const int tid = threadIdx.x, k0 = blockIdx.y * kch, kn = min(kch, K - k0);

  if ((int)blockIdx.x < ncg) {
    const float xs = *xs_ptr;
    for (int i = tid; i < B * kch; i += NT) {
      const int b = i / kch, k = i % kch;
      xq[b * KCH + k] = k < kn ? (int8_t)q8(x[(size_t)b * K + k0 + k], xs) : (int8_t)0;
    }
    for (int i = tid; i < B * COLS; i += NT) sacc[i] = 0;
    __syncthreads();
    const int c4 = tid & 63, lane_k = tid >> 6;
    const int n = blockIdx.x * COLS + 4 * c4;
    int a[MAXB][4];
#pragma unroll
    for (int b = 0; b < MAXB; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) a[b][j] = 0;
    if (n < N) {
      for (int kg = lane_k; 4 * kg < kn; kg += 4) {  // K % 4 == 0: groups are whole
        const int8_t* wp = w + (size_t)(k0 + 4 * kg) * N + n;
        int rw[4], cw[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) rw[i] = __ldg(reinterpret_cast<const int*>(wp + (size_t)i * N));
        transpose4(rw, cw);
#pragma unroll
        for (int b = 0; b < MAXB; ++b) {
          if (b < B) {
            const int xw = *reinterpret_cast<const int*>(xq + b * KCH + 4 * kg);
#pragma unroll
            for (int j = 0; j < 4; ++j) a[b][j] = __dp4a(xw, cw[j], a[b][j]);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < MAXB; ++b)
        if (b < B)
#pragma unroll
          for (int j = 0; j < 4; ++j) atomicAdd(&sacc[b * COLS + 4 * c4 + j], a[b][j]);
    }
    __syncthreads();
    for (int i = tid; i < B * COLS; i += NT) {
      const int gn = blockIdx.x * COLS + i % COLS;
      if (gn < N && sacc[i] != 0) atomicAdd(acc + (size_t)(i / COLS) * N + gn, sacc[i]);
    }
    return;
  }

  // LoRA-A partial sums of this chunk
  for (int i = tid; i < B * kch; i += NT) {
    const int b = i / kch, k = i % kch;
    xr[b * KCH + k] = k < kn ? in_bank<TB>(x[(size_t)b * K + k0 + k]) : 0.f;
  }
  __syncthreads();
  const int j = tid & 63, lane_k = tid >> 6;
  float s[MAXB];
#pragma unroll
  for (int b = 0; b < MAXB; ++b) s[b] = 0.f;
  if (j < r) {
    for (int k = lane_k; k < kn; k += 4) {
      const float av = to_f(la[(size_t)(k0 + k) * r + j]);
#pragma unroll
      for (int b = 0; b < MAXB; ++b)
        if (b < B) s[b] = fmaf(xr[b * KCH + k], av, s[b]);
    }
  }
#pragma unroll
  for (int b = 0; b < MAXB; ++b)
    if (b < B) red[(lane_k * MAXB + b) * MAXR + j] = s[b];
  __syncthreads();
  for (int i = tid; i < B * r; i += NT) {
    const int b = i / r, jj = i % r;
    float v = red[b * MAXR + jj];
    for (int l = 1; l < 4; ++l) v += red[(l * MAXB + b) * MAXR + jj];
    part[(size_t)blockIdx.y * B * r + i] = v;
  }
}

#define MODE_OUT 0     // out = y
#define MODE_RESID 1   // out = resid + y
#define MODE_GELU 2    // out = GELU(y)

// y[b, n] = float(acc) * (xs * ws[n]) + bias[n] + bank(xa[b]) . lb[:, n],
// xa = the LoRA-A partials summed over the nkc chunks in order. ws holds a
// scale per column (ws_col = 1) or one for all (ws_col = 0).
template <typename TB>
__global__ void __launch_bounds__(NT)
k_lin_b(const int* __restrict__ acc, const float* __restrict__ part, const TB* __restrict__ lb,
        const float* __restrict__ ws, int ws_col, const float* __restrict__ bias,
        const float* __restrict__ xs_ptr, const float* __restrict__ resid,
        float* __restrict__ out, int B, int N, int r, int nkc, int mode) {
  __shared__ float xa[MAXB * MAXR];
  for (int i = threadIdx.x; i < B * r; i += NT) {
    float v = part[i];
    for (int c = 1; c < nkc; ++c) v += part[(size_t)c * B * r + i];
    xa[i] = in_bank<TB>(v);
  }
  __syncthreads();
  const int n = blockIdx.x * NT + threadIdx.x;
  if (n >= N) return;
  const float sc = __fmul_rn(*xs_ptr, ws[ws_col ? n : 0]), bn = bias[n];
  for (int b = 0; b < B; ++b) {
    float y = __fadd_rn(__fmul_rn((float)acc[(size_t)b * N + n], sc), bn);
    if (r > 0) {
      float l = 0.f;  // bank x bank products: exact in float32 for bf16 banks
      for (int j = 0; j < r; ++j) l = fmaf(xa[b * r + j], to_f(lb[(size_t)j * N + n]), l);
      y = __fadd_rn(y, l);
    }
    if (mode == MODE_RESID) y = __fadd_rn(resid[(size_t)b * N + n], y);
    else if (mode == MODE_GELU) y = gelu(y);
    out[(size_t)b * N + n] = y;
  }
}

// Rows of K per GEMV block: halved from KCH while the grid is under
// MIN_BLOCKS (down to 16).
static int chunk_rows(int K, int ncg) {
  int kch = KCH;
  while (kch > 16 && ncg * ((K + kch - 1) / kch) < MIN_BLOCKS) kch /= 2;
  return kch;
}

// One linear: acc zeroed, k_lin_a, k_lin_b. part holds ceil(K / 16) * B * r
// floats, acc B * N ints.
template <typename TB>
static int linear(const float* x, const float* xs, const int8_t* w, const float* ws,
                  int ws_col, const float* bias, const void* la, const void* lb,
                  const float* resid,
                  float* out, int* acc, float* part, int B, int K, int N, int r, int mode,
                  cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(acc, 0, sizeof(int) * (size_t)B * N, stream);
  if (e != cudaSuccess) return (int)e;
  const int ncg = (N + COLS - 1) / COLS, kch = chunk_rows(K, ncg);
  const int nkc = (K + kch - 1) / kch;
  k_lin_a<TB><<<dim3(ncg + (r > 0 ? 1 : 0), nkc), NT, 0, stream>>>(
      x, xs, w, static_cast<const TB*>(la), acc, part, B, K, N, r, ncg, kch);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  k_lin_b<TB><<<(N + NT - 1) / NT, NT, 0, stream>>>(
      acc, part, static_cast<const TB*>(lb), ws, ws_col, bias, xs, resid, out, B, N, r, nkc,
      mode);
  return (int)cudaGetLastError();
}

static bool bad_shape(int B, int d, int N, int r) {
  return B < 1 || B > MAXB || r < 0 || r > MAXR || d % 4 || N % 4;
}

template <typename TB>
static int ln_qkv(const float* h, const float* g, const float* bln, const int8_t* w,
                  const float* ws, const float* bias, const float* xs, const void* la,
                  const void* lb, float* out, float* hn, int* acc, float* part, int B, int d,
                  int N, int r, int ws_col, float eps, cudaStream_t stream) {
  k_ln<<<B, NT, 0, stream>>>(h, g, bln, hn, d, eps);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return linear<TB>(hn, xs, w, ws, ws_col, bias, la, lb, nullptr, out, acc, part, B, d, N, r,
                    MODE_OUT, stream);
}

// #12: out (B, N) float32. h (B, d) float32; g, bln (d); w (d, N) int8; ws
// (N) if ws_col, else (1); bias (N); xs (1) float32 on the device; la (d, r),
// lb (r, N) in the bank dtype (bf16 if bank_bf16, else float32), unused when
// r = 0. Workspace: hn (B, d) float32, acc (B, N) int32, part (ceil(d / 16),
// B, r) float32.
extern "C" int fused_ln_qkv(const float* h, const float* g, const float* bln, const int8_t* w,
                            const float* ws, const float* bias, const float* xs, const void* la,
                            const void* lb, float* out, float* hn, int* acc, float* part,
                            int B, int d, int N, int r, int ws_col, int bank_bf16, float eps,
                            cudaStream_t stream) {
  if (bad_shape(B, d, N, r)) return (int)cudaErrorInvalidValue;
  if (bank_bf16)
    return ln_qkv<bf16>(h, g, bln, w, ws, bias, xs, la, lb, out, hn, acc, part, B, d, N, r,
                        ws_col, eps, stream);
  return ln_qkv<float>(h, g, bln, w, ws, bias, xs, la, lb, out, hn, acc, part, B, d, N, r,
                       ws_col, eps, stream);
}

template <typename TB>
static int post(const float* attn, const float* h, const float* g2, const float* b2,
                const int8_t* wp, const float* wps, const float* bp, const void* pa,
                const void* pb, const int8_t* wf, const float* wfs, const float* bf,
                const void* fa, const void* fb, const int8_t* wm, const float* wms,
                const float* bm, const void* ma, const void* mb, const float* xs3, float* out,
                float* h1, float* hn, float* gbuf, int* acc, float* part, int B, int d, int dff,
                int r, int ws_cols, float eps, cudaStream_t stream) {
  int rc = linear<TB>(attn, xs3, wp, wps, ws_cols & 1, bp, pa, pb, h, h1, acc, part, B, d, d, r,
                      MODE_RESID, stream);
  if (rc) return rc;
  k_ln<<<B, NT, 0, stream>>>(h1, g2, b2, hn, d, eps);
  if ((rc = (int)cudaGetLastError())) return rc;
  rc = linear<TB>(hn, xs3 + 1, wf, wfs, (ws_cols >> 1) & 1, bf, fa, fb, nullptr, gbuf, acc, part,
                  B, d, dff, r, MODE_GELU, stream);
  if (rc) return rc;
  return linear<TB>(gbuf, xs3 + 2, wm, wms, (ws_cols >> 2) & 1, bm, ma, mb, h1, out, acc, part,
                    B, dff, d, r, MODE_RESID, stream);
}

// #13: out (B, d) float32. attn, h (B, d) float32; g2, b2 (d); proj (wp
// (d, d), wps, bp (d)), fc (wf (d, dff), wfs, bf (dff)), mlp (wm (dff, d),
// wms, bm (d)), each with LoRA banks (d or dff, r) and (r, d or dff) in the
// bank dtype; bit i of ws_cols set when linear i has a scale per column
// (else one); xs3 (3) float32 on the device. Workspace: h1, hn (B, d) and
// gbuf (B, dff) float32, acc (B, max(d, dff)) int32, part (ceil(dff / 16),
// B, r) float32.
extern "C" int fused_post_attention(
    const float* attn, const float* h, const float* g2, const float* b2, const int8_t* wp,
    const float* wps, const float* bp, const void* pa, const void* pb, const int8_t* wf,
    const float* wfs, const float* bf, const void* fa, const void* fb, const int8_t* wm,
    const float* wms, const float* bm, const void* ma, const void* mb, const float* xs3,
    float* out, float* h1, float* hn, float* gbuf, int* acc, float* part, int B, int d, int dff,
    int r, int ws_cols, int bank_bf16, float eps, cudaStream_t stream) {
  if (bad_shape(B, d, dff, r)) return (int)cudaErrorInvalidValue;
  if (bank_bf16)
    return post<bf16>(attn, h, g2, b2, wp, wps, bp, pa, pb, wf, wfs, bf, fa, fb, wm, wms, bm, ma,
                      mb, xs3, out, h1, hn, gbuf, acc, part, B, d, dff, r, ws_cols, eps, stream);
  return post<float>(attn, h, g2, b2, wp, wps, bp, pa, pb, wf, wfs, bf, fa, fb, wm, wms, bm, ma,
                     mb, xs3, out, h1, hn, gbuf, acc, part, B, d, dff, r, ws_cols, eps, stream);
}
