// Hopper (sm_90a) helpers shared by the TMA + wgmma kernels of this
// directory (causal_conv.cu, flash_attention.cu, flash_attention_train.cu,
// flash_attention_masked.cu, int8_linear.cu, res_block_pair.cu):
// mbarriers, TMA tensor loads and the driver entry that encodes their tensor
// maps, wgmma shared-memory descriptors, the bf16 and s8 products of the
// attention kernels and wgmma's fence / commit / wait, and the register and
// warpgroup controls of a warp-specialised CTA.  Each kernel library
// includes this header once (everything is internal to it).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// Waits for the completion of the barrier's phase of parity `parity`.  A
// wait of 2^34 cycles (~9 s) traps: a broken pipeline faults, not hangs.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile whose rows are KCH bf16
// (KCH * 2 bytes), swizzled by TMA over the row (128B for KCH = 64, 64B
// for 32): 8-row groups at 8 * KCH * 2 bytes (SBO); LBO is unused.  Any
// start 8 rows apart keeps the swizzle phase, so a tile may start at any
// multiple of 8 rows of a staged box; a 16-element step along K advances
// the start by 32 bytes.
template <int KCH>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  constexpr uint64_t layout = KCH == 64 ? 1 : 2;  // 1: 128B swizzle, 2: 64B swizzle
  constexpr uint64_t sbo = (8 * KCH * 2) >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | (sbo << 32) | (layout << 62);
}

// wgmma shared-memory descriptor of an MN-major B operand (read with the
// transpose bit): rows of 64 bf16 along N, one row per K index, swizzled
// 128B by TMA.  8 K rows form a 1024-byte atom (SBO); the next 64 N
// columns start `lbo_bytes` further (LBO).  A 16-row step along K
// advances the start by 2048 bytes.
__device__ __forceinline__ uint64_t smem_desc_mn(uint32_t addr, uint32_t lbo_bytes) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
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

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver that the runtime has loaded (the
// entry point needs CUDA >= 12.5), so the library does not link libcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D bf16 or 8-bit tensor map (dims innermost first, strides of dims
// 1-3 in bytes) with zero fill outside the tensor and rows of box[0]
// elements, 64 or 128 bytes, swizzled for wgmma (64B or 128B).
bool encode_map(CUtensorMap* map, const void* ptr, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box,
                CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const cuuint32_t row_bytes = box[0] * (type == CU_TENSOR_MAP_DATA_TYPE_UINT8 ? 1 : 2);
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

// A tensor map over a contiguous [B, S, N, 128] tensor of bf16 (int8 =
// false) or int8: dims {128, N, S, B}, a box of `rows` token rows of one
// head by 128 bytes (64 bf16 columns, so two boxes per bf16 tile; all 128
// int8 columns), swizzled 128B.  A head-major [B*N, S, 128] tensor is the
// same map with B*N for B and 1 for N.
bool rows_map(CUtensorMap* map, const void* p, int B, int S, int N, int rows,
              bool int8 = false) {
  const cuuint64_t rb = int8 ? 128 : 256;  // bytes of one token row of one head
  const cuuint64_t dims[4] = {128, (cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {rb, rb * N, rb * N * S};
  const cuuint32_t box[4] = {int8 ? 128u : 64u, 1, (cuuint32_t)rows, 1};
  return encode_map(map, p, dims, strides, box,
                    int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
}

// TMA of R token rows [row0, row0 + R) of head n, batch b (a rows_map)
// into a bf16 tile at `dst`: two boxes of 64 columns, [R][128 bytes] each,
// the second R * 128 bytes after the first.  Rows past S arrive as zeros.
template <int R>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int row0, int n, int b) {
  tma_load_4d(dst, map, bar, 0, n, row0, b);
  tma_load_4d(dst + R * 128, map, bar, 64, n, row0, b);
}

// Descriptor of rows [r0, r0 + 64 or R) of an R-row tile read K-major, at
// K step kk (columns 16 kk .. 16 kk + 15).
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
  return smem_desc<64>(tile + (kk >> 2) * (R * 128) + r0 * 128 + (kk & 3) * 32);
}

// Descriptor of an R-row tile read MN-major (rows along K, the 128 columns
// along N), at K step kk (rows 16 kk .. 16 kk + 15).
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return smem_desc_mn(tile + kk * 16 * 128, R * 128);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// Barrier of the 128 threads of consumer warpgroup `wg` (ids 1 and 2).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy reads (wgmma operands, TMA stores) of the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The 64 accumulator operands of an m64n128 wgmma, constraint C.
#define WGMMA_D64(C) \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]), C(d[8]), \
      C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]), C(d[15]), C(d[16]), \
      C(d[17]), C(d[18]), C(d[19]), C(d[20]), C(d[21]), C(d[22]), C(d[23]), C(d[24]), \
      C(d[25]), C(d[26]), C(d[27]), C(d[28]), C(d[29]), C(d[30]), C(d[31]), C(d[32]), \
      C(d[33]), C(d[34]), C(d[35]), C(d[36]), C(d[37]), C(d[38]), C(d[39]), C(d[40]), \
      C(d[41]), C(d[42]), C(d[43]), C(d[44]), C(d[45]), C(d[46]), C(d[47]), C(d[48]), \
      C(d[49]), C(d[50]), C(d[51]), C(d[52]), C(d[53]), C(d[54]), C(d[55]), C(d[56]), \
      C(d[57]), C(d[58]), C(d[59]), C(d[60]), C(d[61]), C(d[62]), C(d[63])
#define WGMMA_R64                                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "        \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "        \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// D (+)= A B, m64n128k16 bf16: A and B K-major in shared memory; scale_d =
// 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db,
                                              uint32_t scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WGMMA_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : WGMMA_D64("+f")
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (+)= A B, m64n128k32 s8 x s8 -> s32: A and B K-major in shared memory
// (one 128-byte int8 row per token); scale_d = 0 overwrites D.  The s32
// accumulator has the f32 one's layout.
__device__ __forceinline__ void wgmma_ss_s8_n128(int* d, uint64_t da, uint64_t db,
                                                 uint32_t scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" WGMMA_R64
      "}, %64, %65, p;\n"
      "}\n"
      : WGMMA_D64("+r")
      : "l"(da), "l"(db), "r"(scale_d));
}

// D += A B, m64n128k16 bf16: A from registers (each warp's 16 rows as the
// m16n8k16 A fragment), B MN-major in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WGMMA_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : WGMMA_D64("+f")
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WGMMA_D64
#undef WGMMA_R64

}  // namespace
