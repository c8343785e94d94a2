// Hopper (sm_90a) helpers shared by the TMA + wgmma kernels of this
// directory (causal_conv.cu, flash_attention_train.cu): mbarriers, TMA
// tensor loads and the driver entry that encodes their tensor maps, wgmma
// shared-memory descriptors and its fence / commit / wait.  Each kernel
// library includes this header once (everything is internal to it).

#pragma once

#include <cuda.h>
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

// A 4-D bf16 tensor map (dims innermost first, strides of dims 1-3 in
// bytes) with zero fill outside the tensor and rows of box[0] = 32 or 64
// elements swizzled for wgmma (64B or 128B).
bool encode_map(CUtensorMap* map, const void* ptr, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            box[0] == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace
