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
// byte at 3.35 TB/s, so operations bound it, narrowly (~11 us).
//
// Design: a CTA owns an M tile (64 rows, 32 when K > 2048) and quantizes
// those rows once into shared memory (64 x 1536 B = 96 KB at K 1536), then
// sweeps its share of the N tiles (128 columns each; the N tiles are split
// over gridDim.y groups so that the grid fills the card) against that
// resident copy, which is the reuse the TPU kernel gets from quantizing at
// the first N step of each M tile.  Weight chunks of 128 x 128 bytes stream
// through a cp.async double buffer.  The products run on mma.sync
// m16n8k32 (s8 x s8 -> s32); 8 warps, each a 16 or 32 x 32 sub-tile.
// Rows of shared memory are padded by 16 bytes so the fragment loads are
// free of bank conflicts.  wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;        // output columns per N tile
constexpr int KC = 128;        // K bytes per streamed weight chunk
constexpr int LDW = KC + 16;   // padded weight row, bytes
constexpr int NTHREADS = 256;  // 8 warps: 2 along M x 4 along N

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_s8(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

__device__ __forceinline__ int quant(float v, float r) {
  return (int)fminf(fmaxf(rintf(__fmul_rn(v, r)), -127.f), 127.f);
}

template <int BM>
__global__ void __launch_bounds__(NTHREADS)
int8_linear_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ w_scale, const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, int M, int N, int K) {
  constexpr int WM = BM / 2;   // rows per warp
  constexpr int MT = WM / 16;  // m16 tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ldx = K + 16;
  int8_t* sX = reinterpret_cast<int8_t*>(smem_raw);         // [BM][ldx]
  int8_t* sW = sX + (size_t)BM * ldx;                        // [2][BN][LDW]
  float* sScale = reinterpret_cast<float*>(sW + 2 * BN * LDW);  // [BM]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.x * BM;

  // quantize this CTA's rows once: one warp per row, 8 bf16 per lane load
  for (int r = warp; r < BM; r += NTHREADS / 32) {
    const int row = m0 + r;
    int8_t* dst = sX + (size_t)r * ldx;
    if (row >= M) {
      for (int c = lane * 8; c < K; c += 256) *reinterpret_cast<uint2*>(dst + c) = make_uint2(0u, 0u);
      if (lane == 0) sScale[r] = 0.f;
      continue;
    }
    const __nv_bfloat16* src = x + (size_t)row * K;
    float amax = 0.f;
    for (int c = lane * 8; c < K; c += 256) {
      const uint4 u = *reinterpret_cast<const uint4*>(src + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(__bfloat162float(e[i])));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    amax = fmaxf(amax, 1e-8f);
    const float rcp = __fdiv_rn(127.f, amax);
    for (int c = lane * 8; c < K; c += 256) {
      const uint4 u = *reinterpret_cast<const uint4*>(src + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
      int qv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[i] = quant(__bfloat162float(e[i]), rcp);
      *reinterpret_cast<uint2*>(dst + c) =
          make_uint2(pack_s8(qv[0], qv[1], qv[2], qv[3]), pack_s8(qv[4], qv[5], qv[6], qv[7]));
    }
    if (lane == 0) sScale[r] = __fmul_rn(amax, (float)(1.0 / 127.0));
  }

  const int n_tiles = (N + BN - 1) / BN;
  const int kchunks = K / KC;
  const int my_tiles = (n_tiles - (int)blockIdx.y + (int)gridDim.y - 1) / (int)gridDim.y;
  const int steps = my_tiles * kchunks;

  auto load_w = [&](int step, int buf) {
    const int n0 = ((int)blockIdx.y + (step / kchunks) * (int)gridDim.y) * BN;
    const int k0 = (step % kchunks) * KC;
    for (int i = tid; i < BN * (KC / 16); i += NTHREADS) {
      const int r = i / (KC / 16), c = (i % (KC / 16)) * 16;
      const bool ok = n0 + r < N;
      cp_async16(sW + ((size_t)buf * BN + r) * LDW + c,
                 w + (size_t)(ok ? n0 + r : 0) * K + k0 + c, ok);
    }
    cp_async_commit();
  };

  int acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;

  if (steps > 0) load_w(0, 0);
  __syncthreads();  // sX and sScale are complete

  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) {
      load_w(step + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = (step % kchunks) * KC;
    const int8_t* sw = sW + (size_t)buf * BN * LDW;
#pragma unroll
    for (int ks = 0; ks < KC / 32; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int8_t* pa = sX + (size_t)(wm * WM + mt * 16 + g) * ldx + k0 + ks * 32 + t4 * 4;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(pa);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(pa + 8 * ldx);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(pa + 16);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(pa + 8 * ldx + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* pb = sw + (size_t)(wn * 32 + nt * 8 + g) * LDW + ks * 32 + t4 * 4;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(pb);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(pb + 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_s8(acc[mt][nt], af[mt], b0, b1);
      }
    }

    if (step % kchunks == kchunks - 1) {  // this N tile is complete: epilogue
      const int n0 = ((int)blockIdx.y + (step / kchunks) * (int)gridDim.y) * BN;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int rl = wm * WM + mt * 16 + g + hh * 8;
          const int row = m0 + rl;
          if (row >= M) continue;
          const float sx = sScale[rl];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int col = n0 + wn * 32 + nt * 8 + t4 * 2;
            if (col >= N) continue;
            float y0 = __fmul_rn(__fmul_rn((float)acc[mt][nt][hh * 2], sx), __ldg(w_scale + col));
            float y1 = __fmul_rn(__fmul_rn((float)acc[mt][nt][hh * 2 + 1], sx),
                                 __ldg(w_scale + col + 1));
            if (bias != nullptr) {
              y0 = __fadd_rn(y0, __ldg(bias + col));
              y1 = __fadd_rn(y1, __ldg(bias + col + 1));
            }
            *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
                __floats2bfloat162_rn(y0, y1);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0;
    }
    __syncthreads();  // this buffer is refilled by the next iteration's load
  }
}

template <int BM>
int launch(const void* x, const void* w, const void* w_scale, const void* bias, void* out,
           int M, int N, int K, int num_sms, cudaStream_t stream) {
  const size_t smem = (size_t)BM * (K + 16) + 2 * BN * LDW + BM * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(int8_linear_kernel<BM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int m_tiles = (M + BM - 1) / BM;
  const int n_tiles = (N + BN - 1) / BN;
  // split the N tiles over enough groups for ~2 CTAs per SM
  int groups = (2 * num_sms + m_tiles - 1) / m_tiles;
  groups = groups < 1 ? 1 : (groups > n_tiles ? n_tiles : groups);
  dim3 grid(m_tiles, groups);
  int8_linear_kernel<BM><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_scale), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: [M, K] bf16; w: [N, K] int8; w_scale: [N] f32; bias: [N] f32 or null;
// out: [M, N] bf16.  K % 128 == 0, K <= 4096, N % 8 == 0.
int longlive_int8_linear(const void* x, const void* w, const void* w_scale, const void* bias,
                         void* out, int M, int N, int K, int num_sms, void* stream) {
  if (K % KC != 0 || K > 4096 || N % 8 != 0 || M <= 0) return (int)cudaErrorInvalidValue;
  if (K <= 2048)
    return launch<64>(x, w, w_scale, bias, out, M, N, K, num_sms, (cudaStream_t)stream);
  return launch<32>(x, w, w_scale, bias, out, M, N, K, num_sms, (cudaStream_t)stream);
}

const char* longlive_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
