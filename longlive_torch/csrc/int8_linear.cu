// Int8 linear with the activation quantize fused in (K5): for each row of x,
//   amax = max(max|x_row| in f32, 1e-8), r = 127 / amax,
//   xq = clip(round_half_even(x * r), -127, 127), s_x = amax * (1/127);
// then y = bf16((float(int32(xq @ Wq^T)) * s_x) * s_W + bias).
// Hopper (sm_90a), bf16 x and y, int8 weights [N, K] (K contiguous) with
// float32 per-output-channel scales.
//
// Replaces: longlive_tpu/ops/quant.py::_mm_q_kernel (the Pallas TPU kernel
// behind linear_int8_fused), which every int8 block linear of the DiT with
// K <= 4096 runs on the serving path (q, k, v, o of self- and
// cross-attention, fc1).
//
// Semantics kept from the TPU kernel: the reciprocal-multiply quantizer
// (the separate-quantize route divides instead, so the two may differ by
// one int8 step at some elements); the integer product is exact in int32;
// the epilogue multiplies by s_x, then by s_W, then adds the bias, each
// rounded separately (__fmul_rn / __fadd_rn, no FMA contraction), and
// rounds once to bf16.
//
// What bounds it on an H100: at M 4680, K 1536, N 1536 the work is
// 2*M*K*N = 22 G int8 operations against ~31 MB of operands, ~700
// operations per byte; the int8 tensor cores (1,979 TOPS) need ~590 per
// byte at 3.35 TB/s, so operations bound it, narrowly (~11 us).  Only s8
// wgmma reaches that rate, and it reads both operands from shared memory,
// K-major.  On the card the products bound this kernel, not its data: a
// build with every TMA load and barrier wait taken out ran no faster, and
// the clock stayed at its 1980 MHz maximum (PERF.md §6).
//
// Design: two kernels per call.  TMA copies bytes, so the int8 operand
// exists before the GEMM reads it:
//   int8_linear_quantize_kernel  one warp per row of x: the row's max |x|,
//        then xq [M, K] int8 and s_x [M] float32 (each row read twice, the
//        second time from L1; xq stays in the 50 MB L2 for the GEMM).
//   int8_linear_gemm_kernel  persistent (one CTA per SM, output tiles of
//        128 rows x 128 columns walked M fastest, so the CTAs of a wave
//        share their W tiles), warp-specialised: a producer warp keeps TMA
//        loads of 128-byte K chunks of xq and W (swizzled 128B) in flight
//        through an mbarrier ring; the two consumer warpgroups take the
//        CTA's tiles in turn (ping-pong), each a whole tile on s8 wgmma
//        m64n128k32 into two s32 accumulators of 64 rows, so one
//        warpgroup's epilogue (the rescale and the bf16 stores) runs beside
//        the other's products; their mainloops take turns through a pair of
//        mbarriers.  On the card this ran faster than two warpgroups
//        sharing each 128 x 256 tile, than 64 x 256 warpgroup tiles, than a
//        ring per warpgroup with both mainloops at once, and than a 2-CTA
//        cluster multicasting W (PERF.md §6).  TMA zero-fills rows past
//        M and N; the epilogue drops them.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"  // mbarriers, TMA, tensor maps, wgmma and its descriptors

namespace {

constexpr int MB = 128;          // output rows per tile
constexpr int BN = 128;          // output columns per tile
constexpr int KC = 128;          // K bytes per stage: one 128-byte swizzled row per operand row
constexpr int THREADS = 384;     // consumer warpgroups 0-1, producer warpgroup 2
constexpr int RING = 192 * 1024; // shared memory of the stage ring
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int QUANT_ROWS = 8;    // rows per quantize CTA (one warp each)
constexpr int MAX_K = 4096;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

__device__ __forceinline__ int quant(float v, float r) {
  return (int)fminf(fmaxf(rintf(__fmul_rn(v, r)), -127.f), 127.f);
}

// One warp per row: amax, the reciprocal, then 8 bf16 -> 8 int8 per lane
// and step of 256 columns (K % 128 == 0: the lanes past the row's end skip
// the last step).
__global__ void __launch_bounds__(QUANT_ROWS * 32)
int8_linear_quantize_kernel(const bf16* __restrict__ x, int8_t* __restrict__ xq,
                            float* __restrict__ sx, int M, int K) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * QUANT_ROWS + (threadIdx.x >> 5);
  if (row >= M) return;
  const bf16* src = x + (size_t)row * K;
  int8_t* dst = xq + (size_t)row * K;
  float amax = 0.f;
  for (int c = lane * 8; c < K; c += 256) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(src + c));
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(__bfloat162float(e[i])));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  amax = fmaxf(amax, 1e-8f);
  const float rcp = __fdiv_rn(127.f, amax);
  for (int c = lane * 8; c < K; c += 256) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(src + c));
    const bf16* e = reinterpret_cast<const bf16*>(&u);
    int qv[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) qv[i] = quant(__bfloat162float(e[i]), rcp);
    *reinterpret_cast<uint2*>(dst + c) =
        make_uint2(pack_s8(qv[0], qv[1], qv[2], qv[3]), pack_s8(qv[4], qv[5], qv[6], qv[7]));
  }
  if (lane == 0) sx[row] = __fmul_rn(amax, (float)(1.0 / 127.0));
}

constexpr int A_BYTES = MB * KC, STAGE = A_BYTES + BN * KC;
constexpr int STAGES = RING / STAGE;
constexpr size_t SMEM = 1024 + RING + 8 * (2 * STAGES + 2);

// amap: xq [M, K] int8 (boxes of MB rows), bmap: W [N, K] int8 (boxes of
// BN rows), 128 bytes of K each.  sx [M], w_scale [N] float32; bias [N]
// float32 or bf16 (bias_bf16, read as its float32 value), or null.
__global__ void __launch_bounds__(THREADS, 1)
int8_linear_gemm_kernel(const __grid_constant__ CUtensorMap amap,
                        const __grid_constant__ CUtensorMap bmap, const float* __restrict__ sx,
                        const float* __restrict__ w_scale, const void* __restrict__ bias,
                        int bias_bf16, bf16* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // swizzle atoms are 1024-aligned
  const uint32_t full = ring + RING, empty = full + 8 * STAGES, turn = empty + 8 * STAGES;
  const int m_tiles = (M + MB - 1) / MB, tiles = m_tiles * ((N + BN - 1) / BN);
  const int kchunks = K / KC;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 1);  // the consumer warpgroup of the stage's tile
    }
    mbar_init(turn, 1);
    mbar_init(turn + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warpgroup: one thread issues every TMA load
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      int s = 0;
      uint32_t round = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile % m_tiles * MB, n0 = tile / m_tiles * BN;
        for (int c = 0; c < kchunks; ++c) {
          if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
          const uint32_t dst = ring + s * STAGE;
          mbar_expect_tx(full + 8 * s, STAGE);
          tma_load_4d(dst, &amap, full + 8 * s, c * KC, m0, 0, 0);
          tma_load_4d(dst + A_BYTES, &bmap, full + 8 * s, c * KC, n0, 0, 0);
          if (++s == STAGES) {
            s = 0;
            ++round;
          }
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: the CTA's tiles i with i % 2 == wg
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  int acc[MB / 64][BN / 2];
  int s = 0, prev = 0;
  uint32_t round = 0;
  int i = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++i) {
    if ((i & 1) != wg) {  // the other warpgroup's tile: step over its chunks in the ring
      s += kchunks;
      round += s / STAGES;
      s %= STAGES;
      continue;
    }
    const int m0 = tile % m_tiles * MB, n0 = tile / m_tiles * BN;
    // the mainloops take turns (the other warpgroup's previous one is
    // done), so no stage's full barrier runs more than one phase ahead of
    // its waiter
    if (i > 0) mbar_wait(turn + 8 * wg, ((i >> 1) - (wg == 0)) & 1);
    // the mainloop's body does not read the accumulator, so ptxas keeps
    // the products of consecutive chunks in flight
    for (int c = 0; c < kchunks; ++c) {
      mbar_wait(full + 8 * s, round & 1);
      const uint32_t a = ring + s * STAGE;
      const uint32_t b = a + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int mb = 0; mb < MB / 64; ++mb)
#pragma unroll
        for (int k = 0; k < KC / 32; ++k)  // 32 bytes of K per product
          wgmma_ss_s8_n128(acc[mb], smem_desc<64>(a + mb * 64 * KC + 32 * k),
                           smem_desc<64>(b + 32 * k), c | k);
      wgmma_commit();
      wgmma_wait<1>();  // the previous chunk's products are done: release its stage
      if (c > 0 && (threadIdx.x & 127) == 0) mbar_arrive(empty + 8 * prev);
      prev = s;
      if (++s == STAGES) {
        s = 0;
        ++round;
      }
    }
    wgmma_wait<0>();
    if ((threadIdx.x & 127) == 0) {
      mbar_arrive(empty + 8 * prev);
      mbar_arrive(turn + 8 * (wg ^ 1));  // the other warpgroup's turn
    }

    // epilogue: y = bf16((acc * s_x) * s_W + bias), rows past M and
    // columns past N dropped (N % 8 == 0: a column pair is in or out whole)
#pragma unroll
    for (int mb = 0; mb < MB / 64; ++mb) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = m0 + mb * 64 + warp * 16 + g + hh * 8;
        const float sr = row < M ? __ldg(sx + row) : 0.f;
        bf16* orow = out + (size_t)row * N;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + j * 8 + tq * 2;
          if (row < M && n0 + j * 8 < N) {
            float y0 = __fmul_rn(__fmul_rn((float)acc[mb][4 * j + 2 * hh], sr),
                                 __ldg(w_scale + col));
            float y1 = __fmul_rn(__fmul_rn((float)acc[mb][4 * j + 2 * hh + 1], sr),
                                 __ldg(w_scale + col + 1));
            if (bias != nullptr) {
              float b0, b1;
              if (bias_bf16) {
                const unsigned short* bb = static_cast<const unsigned short*>(bias) + col;
                b0 = __bfloat162float(__ushort_as_bfloat16(__ldg(bb)));
                b1 = __bfloat162float(__ushort_as_bfloat16(__ldg(bb + 1)));
              } else {
                b0 = __ldg(static_cast<const float*>(bias) + col);
                b1 = __ldg(static_cast<const float*>(bias) + col + 1);
              }
              y0 = __fadd_rn(y0, b0);
              y1 = __fadd_rn(y1, b1);
            }
            *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(y0, y1);
          }
        }
      }
    }
  }
}

// A 2-D int8 [rows, K] tensor map with boxes of 128 bytes x box_rows rows,
// swizzled 128B (dims 3 and 4 of the 4-D map are 1).
bool int8_map(CUtensorMap* map, const void* p, int rows, int K, int box_rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)K, (cuuint64_t)rows, 1, 1};
  const cuuint64_t rb = (cuuint64_t)K * rows;
  const cuuint64_t strides[3] = {(cuuint64_t)K, rb, rb};
  const cuuint32_t box[4] = {KC, (cuuint32_t)box_rows, 1, 1};
  return encode_map(map, p, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_UINT8);
}

int quantize(const void* x, void* xq, void* sx, int M, int K, cudaStream_t stream) {
  int8_linear_quantize_kernel<<<(M + QUANT_ROWS - 1) / QUANT_ROWS, QUANT_ROWS * 32, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx), M, K);
  return (int)cudaGetLastError();
}

int gemm(const void* xq, const void* sx, const void* w, const void* w_scale, const void* bias,
         int bias_bf16, void* out, int M, int N, int K, int num_sms, cudaStream_t stream) {
  // a runtime call first: it makes the device's context current on this
  // thread, which the driver's tensor-map encoder needs
  const cudaError_t err = cudaFuncSetAttribute(
      int8_linear_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap am, bm;
  if (!int8_map(&am, xq, M, K, MB) || !int8_map(&bm, w, N, K, BN))
    return (int)cudaErrorInvalidValue;
  const int tiles = (M + MB - 1) / MB * ((N + BN - 1) / BN);
  int8_linear_gemm_kernel<<<tiles < num_sms ? tiles : num_sms, THREADS, SMEM, stream>>>(
      am, bm, static_cast<const float*>(sx), static_cast<const float*>(w_scale), bias, bias_bf16,
      static_cast<bf16*>(out), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The quantize pass alone: x [M, K] bf16 -> xq [M, K] int8, sx [M] f32.
int longlive_int8_quantize_rows(const void* x, void* xq, void* sx, int M, int K, void* stream) {
  if (K % KC != 0 || K > MAX_K || M <= 0) return (int)cudaErrorInvalidValue;
  return quantize(x, xq, sx, M, K, (cudaStream_t)stream);
}

// x: [M, K] bf16; scratch: M * K + 4 * M bytes, xq [M, K] int8 then sx
// [M] f32 (written by the quantize pass, read by the GEMM); w: [N, K]
// int8; w_scale: [N] f32; bias: [N] f32 or bf16 (bias_bf16), or null; out:
// [M, N] bf16.  K % 128 == 0, K <= 4096, N % 8 == 0; num_sms: the
// persistent CTAs at most.
int longlive_int8_linear(const void* x, void* scratch, const void* w, const void* w_scale,
                         const void* bias, int bias_bf16, void* out, int M, int N, int K,
                         int num_sms, void* stream) {
  if (K % KC != 0 || K > MAX_K || N % 8 != 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  int8_t* xq = static_cast<int8_t*>(scratch);
  float* sx = reinterpret_cast<float*>(xq + (size_t)M * K);
  const int rc = quantize(x, xq, sx, M, K, st);
  if (rc != 0) return rc;
  return gemm(xq, sx, w, w_scale, bias, bias_bf16, out, M, N, K, num_sms, st);
}

const char* longlive_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
