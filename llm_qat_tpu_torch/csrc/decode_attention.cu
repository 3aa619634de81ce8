// One-token decode attention with in-place append, for sm_90a: dense caches
// (#9) and packed caches (#7/#8).
//
// Replaces three Pallas kernels of llm_qat_tpu/ops/decode_attention.py:
// `_decode_attn_kernel` behind `decode_attention` (dense (B, H, T, D)
// caches, #9), `_hbm_kernel` behind `decode_attention_hbm` (packed caches,
// one shared position, #7) and `_hbm_kernel_multi` behind
// `decode_attention_hbm_multi` (packed caches, a position per slot, -1 =
// inactive, #8). #7 and #8 run one kernel, `k_decode_hbm`, which takes a
// position per slot (the shared-position wrapper passes the same one for
// every slot); #9 runs `k_decode_dense`. The Python wrappers are in
// llm_qat_tpu_torch/ops/decode_attention.py, with their plain PyTorch
// versions and the launch plans (`dense_split`, `hbm_split`) beside them.
//
// Bound. Per (b, h) a call reads q, the live prefix of K and V once and
// writes D output floats and one row (dense) or lane group (packed) of K and
// V: at path B's shape (B 8, H 12, D 64, bf16, pos 160) about 4 MB, 1.2 us
// at 3.35 TB/s; its 4 D operations per timestep are far below the card's
// operations-per-byte line. So the bytes bound it, but at these sizes the
// time is latency: the launch, one round trip to device memory and the
// barriers.
//
// Design (both kernels). One thread block cluster of S blocks (1 <= S <= 8,
// chosen on the host from the longest live prefix) per (b, h): grid B*H*S,
// launched with `cudaLaunchKernelEx`. Each block of the cluster takes a
// contiguous part of its slot's prefix, cut from that slot's own position,
// so slots at different positions split differently. A block issues every
// 16-byte load of its first chunk of K and V rows (UNROLL vectors of each a
// thread) before it uses any, takes float32 scores as products summed over
// the lanes of a row (a shuffle over the row's threads), and writes its
// maxima to shared memory. After `cluster.sync()` every block reads the
// maxima of all blocks through distributed shared memory; a maximum is
// exact in any order, so each block rounds and exponentiates at exactly the
// maximum of the plain version. Each block then writes its partial row sum
// and P.V to shared memory; after a second `cluster.sync()` block r sums
// the partials of all blocks in rank order for its slice of the D output
// lanes and stores them. A last `cluster.sync()` keeps a block from leaving
// while another still reads its shared memory. No atomics, no workspace,
// one launch: two calls give bit-equal outputs. Scores, sums and the
// softmax are float32; products of bf16 values are exact in float32, so a
// kernel and its plain version differ by the order of float32 sums only.
//
// #9 (`k_decode_dense`), as the TPU kernel: row pos of K and V is written
// in the cache dtype, then q*sm_scale (float32, not rounded) attends over
// rows 0 .. pos with one exact softmax whose probabilities stay float32.
// Block r of the cluster takes rows [r*per, min(n, (r+1)*per)) of the
// n = pos + 1 rows, per = ceil(n / S); the block that owns row pos writes
// it and takes its score and value from kn, vn rounded to the cache dtype
// (the value the plain version reads back), so no block reads row pos from
// device memory. One maximum per block is exchanged.
//
// #7/#8 (`k_decode_hbm`). A packed cache is (B, H, T/P, 128): packed row u
// holds timesteps P*u .. P*u + P - 1 in lane groups of D = 128 / P lanes.
// The TPU kernel streams the prefix [0, pos) in JAX blocks of `tbp` packed
// rows with an online softmax: q*sm_scale is rounded to the cache dtype,
// and each block's probabilities are rounded to the cache dtype at the
// running maximum m_run[j] = max(bmax[0..j]) of the JAX blocks so far. The
// split keeps those rounding points: block r of the cluster takes JAX
// blocks [r*per, min(nblk, (r+1)*per)), per = ceil(nblk / S), computes
// their maxima (over all lane groups), and after `cluster.sync()` reads the
// maxima of all nblk JAX blocks and forms their prefix maxima. JAX block j
// then rounds p = expf(s - m_run[j]) to the cache dtype before P.V, adds
// the unrounded p to the row sum, and both are scaled by
// expf(m_run[j] - M), M the last prefix maximum, which stands for the TPU
// kernel's chain of corrections. The new token's K/V go through the cache
// dtype and merge last, with its score against the unrounded q. Block 0
// appends the lane group of row pos / P that belongs to pos, for slots with
// pos >= 0, after the second `cluster.sync()`: after every read of the
// cache in the cluster.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define NEG_INF (-1e30f)
#define MAX_SLOTS 256
#define MAX_SPLIT 8      // blocks of a cluster, the portable limit
#define THREADS 128
#define WARPS (THREADS / 32)
#define ROW 128          // lanes of a packed row (P * D)
#define UNROLL 4         // 16-byte vectors of K (and of V) in flight per thread
#define MAX_SMEM (227 * 1024)

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

// Elements of T in one 16-byte vector.
template <typename T> struct Vec {
  static constexpr int N = 16 / (int)sizeof(T);
};

__device__ __forceinline__ uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// The elements of T in a 16-byte vector, as floats.
template <typename T> __device__ __forceinline__ void unpack(const uint4& w, float* f);
template <> __device__ __forceinline__ void unpack<float>(const uint4& w, float* f) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}
template <> __device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& w, float* f) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// v summed over the aligned group of `width` lanes (a power of 2) holding it.
__device__ __forceinline__ float group_sum(float v, int width) {
  for (int o = width / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The partial P.V sums of the block, `acc` (VEC lanes c0 .. of this
// thread's row in pass rr), summed over the rows of a pass in order into
// dst[0 .. width), and the row sums `ls` (counted once per score) into
// *lsum; `part` holds THREADS * VEC floats, `red` WARPS.
template <int VEC>
__device__ __forceinline__ void block_partials(const float* acc, float ls, int rr, int c0,
                                               int width, float* part, float* red, float* dst,
                                               float* lsum) {
  const int tid = threadIdx.x, rows = THREADS * VEC / width;
#pragma unroll
  for (int e = 0; e < VEC; ++e) part[rr * width + c0 + e] = acc[e];
  ls = warp_sum(ls);
  if ((tid & 31) == 0) red[tid >> 5] = ls;
  __syncthreads();
  for (int i = tid; i < width; i += THREADS) {
    float o = 0.f;
    for (int r = 0; r < rows; ++r) o += part[r * width + i];
    dst[i] = o;
  }
  if (tid == 0) {
    float l = 0.f;
    for (int w = 0; w < WARPS; ++w) l += red[w];
    *lsum = l;
  }
}

// #9. q, kn, vn: (B*H, D) float32; kc, vc: (B*H, Tn, D) of T; out (B*H, D).
// 0 <= pos < Tn for every slot; D is 32, 64 or 128; grid B*H*S, cluster S.
// Shared memory (floats): the exported xs = [max, l, o[D]], red[WARPS],
// part[THREADS * VEC], sc[per].
template <typename T>
__global__ void __launch_bounds__(THREADS)
k_decode_dense(const float* __restrict__ q, const float* __restrict__ kn,
               const float* __restrict__ vn, T* kc, T* vc, float* __restrict__ out,
               SlotPos pos, int H, int D, int Tn, float sm_scale) {
  constexpr int VEC = Vec<T>::N;
  extern __shared__ float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / S, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = pos.v[bh / H], n = p + 1, per = (n + S - 1) / S;
  const int r0 = min(n, rank * per), r1 = min(n, r0 + per);
  const int lpr = D / VEC, rpp = THREADS / lpr;  // threads per row, rows per pass
  const int lr = tid % lpr, rr = tid / lpr, c0 = lr * VEC;
  const int chunk = rpp * UNROLL;
  float* xs = sm;
  float* red = xs + 2 + D;
  float* part = red + WARPS;
  float* sc = part + THREADS * VEC;

  T* kb = kc + (size_t)bh * Tn * D;
  T* vb = vc + (size_t)bh * Tn * D;
  const float* knr = kn + (size_t)bh * D;
  const float* vnr = vn + (size_t)bh * D;
  if (r0 <= p && p < r1)  // the owner of row pos writes it; no block reads it back
    for (int i = tid; i < D; i += THREADS) {
      kb[(size_t)p * D + i] = from_f<T>(knr[i]);
      vb[(size_t)p * D + i] = from_f<T>(vnr[i]);
    }

  // every load of the first chunk issued before any is used: V, then K
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 kv[UNROLL], vv[UNROLL];
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const int t = r0 + rr + k * rpp;
    vv[k] = t < r1 && t != p ? ld16(vb + (size_t)t * D + c0) : zero;
  }
  float qs[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) qs[e] = q[(size_t)bh * D + c0 + e] * sm_scale;

  float mloc = NEG_INF;
  for (int c = r0; c < r1; c += chunk) {
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int t = c + rr + k * rpp;
      kv[k] = t < r1 && t != p ? ld16(kb + (size_t)t * D + c0) : zero;
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int t = c + rr + k * rpp;
      float kf[VEC];
      unpack<T>(kv[k], kf);
      if (t == p)
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = in_cdt<T>(knr[c0 + e]);
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) s += qs[e] * kf[e];
      s = group_sum(s, lpr);
      if (t < r1) {
        if (lr == 0) sc[t - r0] = s;
        mloc = fmaxf(mloc, s);
      }
    }
  }
  mloc = warp_max(mloc);
  if (lane == 0) red[warp] = mloc;
  __syncthreads();
  if (tid == 0) {
    float m = red[0];
    for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w]);
    xs[0] = m;
  }
  cluster.sync();  // the maxima and the scores are visible
  float m = lane < S ? *cluster.map_shared_rank(xs, lane) : NEG_INF;
  m = warp_max(m);  // the maximum over rows 0 .. pos

  float acc[VEC], ls = 0.f;
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  for (int c = r0; c < r1; c += chunk) {
    if (c != r0)
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int t = c + rr + k * rpp;
        vv[k] = t < r1 && t != p ? ld16(vb + (size_t)t * D + c0) : zero;
      }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int t = c + rr + k * rpp;
      if (t >= r1) continue;
      const float pr = expf(sc[t - r0] - m);
      if (lr == 0) ls += pr;
      float vf[VEC];
      unpack<T>(vv[k], vf);
      if (t == p)
#pragma unroll
        for (int e = 0; e < VEC; ++e) vf[e] = in_cdt<T>(vnr[c0 + e]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += pr * vf[e];
    }
  }
  block_partials<VEC>(acc, ls, rr, c0, D, part, red, xs + 2, xs + 1);
  cluster.sync();  // every block's partials are visible

  const int dper = (D + S - 1) / S, d1 = min(D, (rank + 1) * dper);
  for (int i = rank * dper + tid; i < d1; i += THREADS) {
    float o = 0.f, l = 0.f;
    for (int r = 0; r < S; ++r) {
      const float* x = cluster.map_shared_rank(xs, r);
      o += x[2 + i];
      l += x[1];
    }
    out[(size_t)bh * D + i] = o / fmaxf(l, 1e-30f);
  }
  cluster.sync();  // no block leaves while another reads its partials
}

// #7/#8. q, kn, vn: (B*H, D) float32; kc, vc: (B*H, Tp, ROW) of T; out
// (B*H, D). pos -1 (inactive) .. P * Tp - 1; grid B*H*S, cluster S.
// Shared memory (floats): the exported xs = [l, acc[ROW]] and bm[per],
// then red[WARPS], snew, allb[nblk of the longest prefix],
// part[THREADS * VEC], sc[per * tbp * P].
template <typename T>
__global__ void __launch_bounds__(THREADS)
k_decode_hbm(const float* __restrict__ q, const float* __restrict__ kn,
             const float* __restrict__ vn, T* kc, T* vc, float* __restrict__ out,
             SlotPos pos, int H, int D, int Tp, int P, int tbp, int nblk_max,
             float sm_scale) {
  constexpr int VEC = Vec<T>::N;
  constexpr int RPP = THREADS * VEC / ROW;  // packed rows per pass
  constexpr int CHUNK = RPP * UNROLL;
  extern __shared__ float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / S, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = pos.v[bh / H];
  const int live = p > 0 ? (p + P - 1) / P : 0;  // packed rows holding [0, p)
  const int nblk = (live + tbp - 1) / tbp;       // JAX blocks of the prefix
  const int per = (nblk + S - 1) / S;
  const int j0 = min(nblk, rank * per), j1 = min(nblk, j0 + per);
  const int lr = tid % (ROW / VEC), rr = tid / (ROW / VEC), c0 = lr * VEC;
  const int g = c0 / D, lpg = D / VEC;  // lane group, threads per lane group
  const int u0 = j0 * tbp, u1 = j1 * tbp, ulive = min(u1, live);
  float* xs = sm;
  float* bm = xs + 1 + ROW;
  float* red = bm + per;
  float* snew = red + WARPS;
  float* allb = snew + 1;
  float* part = allb + nblk_max;
  float* sc = part + THREADS * VEC;

  const T* kb = kc + (size_t)bh * Tp * ROW;
  const T* vb = vc + (size_t)bh * Tp * ROW;
  const float* qrow = q + (size_t)bh * D;
  const float* knr = kn + (size_t)bh * D;
  const float* vnr = vn + (size_t)bh * D;

  // every load of the first chunk issued before any is used: V, then K
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 kv[UNROLL], vv[UNROLL];
#pragma unroll
  for (int k = 0; k < UNROLL; ++k) {
    const int u = u0 + rr + k * RPP;
    vv[k] = u < ulive && u < u0 + tbp ? ld16(vb + (size_t)u * ROW + c0) : zero;
  }
  float qm[VEC];  // q*sm_scale in the cache dtype, as the TPU kernel's Qm
#pragma unroll
  for (int e = 0; e < VEC; ++e) qm[e] = in_cdt<T>(qrow[(c0 + e) % D] * sm_scale);
  if (warp == 0) {  // the new token's score, against the unrounded q
    float s = 0.f;
    for (int i = lane; i < D; i += 32) s += qrow[i] * sm_scale * in_cdt<T>(knr[i]);
    s = warp_sum(s);
    if (lane == 0) *snew = s;
  }

  // scores of the block's JAX blocks (NEG_INF at t >= pos) into sc
  for (int c = u0; c < u1; c += CHUNK) {
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int u = c + rr + k * RPP;
      kv[k] = u < ulive ? ld16(kb + (size_t)u * ROW + c0) : zero;
    }
#pragma unroll
    for (int k = 0; k < UNROLL; ++k) {
      const int u = c + rr + k * RPP;
      float kf[VEC];
      unpack<T>(kv[k], kf);
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) s += qm[e] * kf[e];
      s = group_sum(s, lpg);
      if (u < u1 && lr % lpg == 0) sc[(u - u0) * P + g] = u * P + g < p ? s : NEG_INF;
    }
  }
  __syncthreads();
  // the maxima of the block's JAX blocks, one warp each
  const int nb = tbp * P;
  for (int j = warp; j < j1 - j0; j += WARPS) {
    float mx = NEG_INF;
    for (int x = lane; x < nb; x += 32) mx = fmaxf(mx, sc[j * nb + x]);
    mx = warp_max(mx);
    if (lane == 0) bm[j] = mx;
  }
  cluster.sync();  // every block's JAX block maxima are visible
  for (int k = tid; k < nblk; k += THREADS)
    allb[k] = *cluster.map_shared_rank(bm + k % per, k / per);
  __syncthreads();
  float mr = NEG_INF, M = NEG_INF;  // running maximum before JAX block j0; the last
  for (int k = 0; k < nblk; ++k) {
    if (k < j0) mr = fmaxf(mr, allb[k]);
    M = fmaxf(M, allb[k]);
  }

  float acc[VEC], ls = 0.f;
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  for (int j = j0; j < j1; ++j) {
    mr = fmaxf(mr, allb[j]);  // m_run[j]
    const float w = expf(mr - M);
    const int ue = min((j + 1) * tbp, live);
    float pv[VEC], ps = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) pv[e] = 0.f;
    for (int c = j * tbp; c < ue; c += CHUNK) {
      if (c != u0)
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
          const int u = c + rr + k * RPP;
          vv[k] = u < ue ? ld16(vb + (size_t)u * ROW + c0) : zero;
        }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const int u = c + rr + k * RPP;
        if (u >= ue) continue;
        const float e0 = expf(sc[(u - u0) * P + g] - mr);
        if (lr % lpg == 0) ps += e0;
        const float pr = in_cdt<T>(e0);
        float vf[VEC];
        unpack<T>(vv[k], vf);
#pragma unroll
        for (int e = 0; e < VEC; ++e) pv[e] += pr * vf[e];
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] += pv[e] * w;
    ls += ps * w;
  }
  block_partials<VEC>(acc, ls, rr, c0, ROW, part, red, xs + 1, xs);
  cluster.sync();  // every block's partials are visible; every cache read is done

  if (rank == 0 && p >= 0) {  // the append: the lane group of row p / P for pos
    const size_t at = ((size_t)bh * Tp + p / P) * ROW + (p % P) * D;
    for (int i = tid; i < D; i += THREADS) {
      kc[at + i] = from_f<T>(knr[i]);
      vc[at + i] = from_f<T>(vnr[i]);
    }
  }
  const float s_new = *snew;
  const float m_f = fmaxf(M, s_new);
  const float corr = expf(M - m_f);
  const float p_new = expf(s_new - m_f);
  const int dper = (D + S - 1) / S, d1 = min(D, (rank + 1) * dper);
  for (int i = rank * dper + tid; i < d1; i += THREADS) {
    float o = 0.f, l = 0.f;
    for (int r = 0; r < S; ++r) {
      const float* x = cluster.map_shared_rank(xs, r);
      float og = x[1 + i];
      for (int grp = 1; grp < P; ++grp) og += x[1 + grp * D + i];
      o += og;
      l += x[0];
    }
    o = o * corr + p_new * in_cdt<T>(vnr[i]);
    out[(size_t)bh * D + i] = o / fmaxf(l * corr + p_new, 1e-30f);
  }
  cluster.sync();  // no block leaves while another reads its partials
}

template <typename Kernel, typename... Args>
static cudaError_t launch(Kernel kernel, int blocks, int split, size_t smem,
                          cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {  // the attribute is per function; set it once to the most
    static bool attr_set = false;
    if (!attr_set) {
      const cudaError_t e =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
      if (e != cudaSuccess) return e;
      attr_set = true;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(blocks * split));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// #9: pos_host B positions in host memory, each 0 <= pos < T, copied into
// the launch's arguments (no device copy, no host sync); cdt 0 float32,
// 1 bfloat16; split: blocks of a cluster per (b, h), 1-8, from
// ops/decode_attention.py::dense_split.
extern "C" int decode_attention_dense(const float* q, const float* kn, const float* vn,
                                      void* kc, void* vc, float* out, const int* pos_host,
                                      int B, int H, int D, int T, int cdt, int split,
                                      float sm_scale, cudaStream_t stream) {
  if (B < 1 || B > MAX_SLOTS || (D != 32 && D != 64 && D != 128) || split < 1 ||
      split > MAX_SPLIT || (cdt != 0 && cdt != 1))
    return (int)cudaErrorInvalidValue;
  SlotPos sp;
  int n = 0;
  for (int b = 0; b < B; ++b) {
    if (pos_host[b] < 0 || pos_host[b] >= T) return (int)cudaErrorInvalidValue;
    sp.v[b] = pos_host[b];
    if (pos_host[b] + 1 > n) n = pos_host[b] + 1;
  }
  const int vec = cdt == 0 ? 4 : 8;
  const size_t smem = sizeof(float) * (2 + D + WARPS + THREADS * vec + (n + split - 1) / split);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (cdt == 0)
    return (int)launch(k_decode_dense<float>, B * H, split, smem, stream, q, kn, vn,
                       static_cast<float*>(kc), static_cast<float*>(vc), out, sp, H, D, T,
                       sm_scale);
  return (int)launch(k_decode_dense<__nv_bfloat16>, B * H, split, smem, stream, q, kn, vn,
                     static_cast<__nv_bfloat16*>(kc), static_cast<__nv_bfloat16*>(vc), out, sp,
                     H, D, T, sm_scale);
}

// #7/#8: pos_host as for #9, each -1 .. P * Tp - 1; tbp packed rows per JAX
// block (a multiple of 8 dividing Tp); split from
// ops/decode_attention.py::hbm_split.
extern "C" int decode_attention_hbm(const float* q, const float* kn, const float* vn,
                                    void* kc, void* vc, float* out, const int* pos_host,
                                    int B, int H, int D, int Tp, int P, int tbp, int cdt,
                                    int split, float sm_scale, cudaStream_t stream) {
  if (B < 1 || B > MAX_SLOTS || P * D != ROW || D % 8 || tbp < 1 || split < 1 ||
      split > MAX_SPLIT || (cdt != 0 && cdt != 1))
    return (int)cudaErrorInvalidValue;
  SlotPos sp;
  int nblk = 0;
  for (int b = 0; b < B; ++b) {
    if (pos_host[b] < -1 || pos_host[b] >= P * Tp) return (int)cudaErrorInvalidValue;
    sp.v[b] = pos_host[b];
    const int nb = (pos_host[b] + P * tbp - 1) / (P * tbp);
    if (nb > nblk) nblk = nb;
  }
  const int vec = cdt == 0 ? 4 : 8, per = (nblk + split - 1) / split;
  const size_t smem =
      sizeof(float) * (1 + ROW + per + WARPS + 1 + nblk + THREADS * vec + per * tbp * P);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  if (cdt == 0)
    return (int)launch(k_decode_hbm<float>, B * H, split, smem, stream, q, kn, vn,
                       static_cast<float*>(kc), static_cast<float*>(vc), out, sp, H, D, Tp, P,
                       tbp, nblk, sm_scale);
  return (int)launch(k_decode_hbm<__nv_bfloat16>, B * H, split, smem, stream, q, kn, vn,
                     static_cast<__nv_bfloat16*>(kc), static_cast<__nv_bfloat16*>(vc), out, sp,
                     H, D, Tp, P, tbp, nblk, sm_scale);
}
