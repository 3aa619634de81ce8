// Hopper (sm_90a) building blocks shared by the port's kernels: the TMA-fed
// wgmma kernels of `csrc/fused_linear.cu` (#14-#16) and
// `csrc/flash_attention.cu` (#2/#5/#6 with bf16 operands), and the persistent
// cooperative kernels of `csrc/mega_decode.cu` (#1/#3/#4) and
// `csrc/fused_decode.cu` (#12/#13). PTX wrappers for mbarriers, TMA and
// bulk copies into shared memory, the grid barrier and an L2 prefetch,
// wgmma's shared-memory descriptors and its m64n64,
// m64n128 and m64n256 bf16 products (shared-memory operands, and m64n64
// with A from registers), and on the host the tensor-map encoders.
// Included by the sources; `ops/_build.py` hashes it with each of them.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the barrier's phase of the given parity has completed. A wait
// of more than about 2^34 cycles (seconds; a stage normally arrives within
// microseconds) can only be a lost arrival: the kernel then traps, and the
// launch fails with an error instead of holding the card forever.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1LL << 34)) __trap();
  }
}

// The box of a bf16 tensor map at (inner, outer) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int inner,
                                         int outer, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(inner), "r"(outer), "r"(bar)
      : "memory");
}

// The box of a 3-D bf16 tensor map at (c0, c1, c2) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes from global src (16-byte
// aligned) into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Grid barrier of a cooperative launch (the algorithm of cooperative_groups'
// grid sync) on the counter *bar in device memory: block 0 adds
// 2^31 - (nb - 1), every other block 1, so the top bit of the counter flips
// once all have arrived and its low bits return to where they were; after
// an even number of barriers the counter is as the launch found it. A wait
// of more than about 2^34 cycles traps. Instrumentation: with clk set, the
// global timer (ns) at block i's arrival at barrier k goes to
// clk[(2k) nb + i] and at its release to clk[(2k + 1) nb + i].
__device__ void grid_sync(unsigned* bar, unsigned long long* clk, int nb, int& nbar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    if (clk) clk[(size_t)(2 * nbar) * nb + blockIdx.x] = global_ns();
    const unsigned inc = blockIdx.x == 0 ? 0x80000000u - (unsigned)(nb - 1) : 1u;
    __threadfence();
    const unsigned old = atomicAdd(bar, inc);
    const long long t0 = clock64();
    while (((old ^ ld_acquire(bar)) & 0x80000000u) == 0) {
      if (clock64() - t0 > (1LL << 34)) __trap();
    }
    __threadfence();
    if (clk) clk[(size_t)(2 * nbar + 1) * nb + blockIdx.x] = global_ns();
  }
  ++nbar;
  __syncthreads();
}

// [p, p + bytes) into L2, in pieces of at most 32 KB, widened to 16-byte
// bounds (inside the allocation: PyTorch rounds allocations to 512 bytes).
__device__ __forceinline__ void l2_prefetch(const void* p, size_t bytes) {
  if (!p || !bytes) return;
  uintptr_t a = reinterpret_cast<uintptr_t>(p) & ~(uintptr_t)15;
  const uintptr_t e = (reinterpret_cast<uintptr_t>(p) + bytes + 15) & ~(uintptr_t)15;
  for (; a < e; a += 32768) {
    const unsigned n = (unsigned)(e - a < 32768 ? e - a : 32768);
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(a), "r"(n) : "memory");
  }
}

// wgmma shared-memory descriptor of the k16 slice kk of a tile written by
// TMA with the 128-byte swizzle (layout type 1), its base 1024-byte
// aligned; SBO = 1024 bytes, the next 8 rows of 128 bytes. K-major (MN =
// false): a row is one M or N index, 64 K values wide, LBO unused (1), and
// a k16 slice starts 32 bytes further. MN-major (MN = true): a row is one K
// index, 64 M or N values wide; LBO = SW128_BOX, the next 64 M or N values
// (the tile's next box of 64 rows), and a k16 slice starts 16 rows (2048
// bytes) further.
constexpr uint32_t SW128_BOX = 64 * 128;  // 64 rows of one 128-byte swizzle row
template <bool MN>
__device__ __forceinline__ uint64_t sdesc(uint32_t tile, int kk) {
  const uint32_t addr = tile + (MN ? 16 * 128 : 32) * kk;
  const uint32_t lbo = MN ? SW128_BOX : 16, sbo = 1024;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}

// Pins the NA accumulators, so that the compiler moves no access to them
// across an asynchronous wgmma.
template <int NA>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < NA; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for N registers of bf16 pairs that an asynchronous wgmma reads
// (the A operand of the register form): the compiler may not reuse them
// before the wgmma_wait that follows.
template <int N>
__device__ __forceinline__ void fence_frag(uint32_t* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d[64 x BN] (+)= A[64 x 16] . B[16 x BN] from shared memory, BN = 64, 128
// or 256 (BN/2 float32 accumulators a thread): both operands K-major (A .
// B^T of two k-contiguous tiles), or with MN both MN-major (imm-trans-a =
// imm-trans-b = 1: A^T . B of two tiles whose rows are k). With accumulate
// = 0 the product overwrites d.
template <int BN, bool MN>
__device__ __forceinline__ void wgmma(float* d, uint64_t da, uint64_t db, int accumulate = 1) {
  if constexpr (BN == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate), "n"(MN ? 1 : 0));
  } else if constexpr (BN == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate), "n"(MN ? 1 : 0));
  } else {
    static_assert(BN == 256, "wgmma tiles are 64, 128 or 256 wide");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
        "%128, %129, p, 1, 1, %131, %131;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
          "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
          "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
          "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
          "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(accumulate), "n"(MN ? 1 : 0));
  }
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (wgmma's
// register form): a[0..3] are the thread's bf16 pairs of A in the layout of
// a float32 accumulator's columns 16 kk .. 16 kk + 15 (accumulators 8 kk ..
// 8 kk + 7, two to a register, the lower column in the low half), B from
// shared memory, K-major or, with MNB, MN-major (imm-trans-b = 1).
template <bool MNB>
__device__ __forceinline__ void wgmma_rs64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(MNB ? 1 : 0), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime; it is taken
// with dlopen from the libcuda.so.1 the runtime has already loaded, so that
// nothing links against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (h) fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// The map of a bf16 matrix (rows, inner) with row stride ld elements, read
// in boxes of 64 inner values (128 bytes, the 128-byte swizzle) x box_rows
// rows: GM rows for the K-major operands of #14/#15, GK for the MN-major
// ones of #16. Boxes past the edge are filled with zeros.
static int bf16_map(CUtensorMap* map, const void* ptr, int inner, int rows, int ld,
                    int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult rc = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                          strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The map of a bf16 tensor (outer, rows, cols) with rows of cols contiguous
// values (cols a multiple of 64), read in boxes of 64 values x box_rows rows
// x 1 with the 128-byte swizzle (box h of a row at inner coordinate 64 h).
// A box that reaches past `rows` is filled with zeros there: it never reads
// the next outer index's rows.
static int bf16_map3(CUtensorMap* map, const void* ptr, int cols, int rows, int outer,
                     int box_rows) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult rc = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                          strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}
