// A whole no-shortcut residual block of the streaming VAE decoder in one
// launch: out = conv2(silu(norm2(conv1(silu(norm1(x)))))) + x, both causal
// convs 3x3x3 with stride 1 and SAME spatial padding, with both convs' new
// 2-frame caches as side outputs.  Hopper (sm_90a), bf16 activations and
// weights, float32 accumulation.
//
// Replaces: longlive_tpu/ops/vae_conv.py::_pair_kernel (the Pallas TPU
// kernel behind fused_res_block, the decoder's LONGLIVE_VAE_PAIR=1 mode).
//
// Semantics kept from the TPU kernel, which equal the chain of two fused
// causal convs (csrc/causal_conv.cu) at the same rounding points:
//   * conv1 reads the virtual frames [cache1 0, cache1 1, x0', x1', ...]
//     with xj' = bf16 norm1 + SiLU of x frame j: y = bf16(x / (||x|| +
//     1e-12) * sqrt(C) * gamma1), s = bf16(sigmoid(y)), xj' = bf16(y * s);
//   * y_t = bf16(conv1 over virtual frames t..t+2 + b1);
//   * z_t = norm2 + SiLU of y_t (the same formula, gamma2);
//   * out_t = bf16(conv2 over [cache2 0, cache2 1, z0, z1, ...] at t..t+2
//     + b2), then + x_t in bf16;
//   * SAME padding is zero in the normalised domain (x' and z);
//   * new cache1 / cache2 = the last two virtual frames of each conv's input
//     (for T = 1: [cache frame 1, the new frame]).
//
// What bounds it on an H100: 2 x 27 C^2 multiply-adds per output pixel and
// frame, e.g. C = 96 at 480x832 x 4 frames is ~1.6 TFLOP against ~0.4 GB of
// activations, so tensor-core throughput bounds it; the halo recompute
// below adds (TH+2)(TW+2) / (TH TW) to conv1's share (1.56x for 8x8).
//
// Design: one CTA per output tile of 8 x TW pixels (TW = 8, or 4 where the
// 8-wide ring does not fit), walking the frames t = 0..T-1 in order and all
// C channels; 8 warps.  For each frame:
//   1. conv1 over the tile with its 1-pixel halo ((8+2) x (TW+2) pixels, an
//      implicit GEMM: M = halo pixels, N = C in chunks of 96, K = 27 C):
//      the input tile with a 2-pixel halo is staged 32 channels at a time,
//      normalised while it is staged (per-pixel norms computed once per
//      frame), and the weights one (tap, kernel row) block of 3 x 96 x 32
//      at a time; A fragments come from ldmatrix with one row address per
//      lane, which gathers the shifted pixels of each (kernel row, column)
//      tap for free; mma.sync m16n8k16 (bf16 -> f32).  y = bf16(acc + b1)
//      goes into a ring of min(T, 3) frames of (8+2) x (TW+2) x C in shared
//      memory;
//   2. norm2 + SiLU in place over each halo pixel (one warp per pixel,
//      whole channel vectors: this is why a CTA owns all C channels);
//      pixels outside the image become 0 (conv2's SAME padding);
//   3. conv2 over the 8 x TW tile from the ring (frames t-2..t) or, while
//      t < 2, from cache2 staged 32 channels at a time; + b2, bf16, + x.
// Only the outputs and the two cache frames of each conv go to HBM; the
// halo of conv1 is recomputed by the neighbouring CTAs (the one redundancy,
// as in the TPU kernel).  Not pipelined yet: staging and products alternate
// behind __syncthreads; wgmma, TMA and double buffering are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;          // output tile rows
constexpr int NB = 96;         // output channels per chunk (96 divides every decoder width)
constexpr int KC = 32;         // input channels per staged chunk
constexpr int LDA = KC + 8;    // padded staged row, in bf16
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ __nv_bfloat16 norm_silu(float x, float nrm, float sqrt_c, float gamma) {
  const __nv_bfloat16 y = __float2bfloat16(x / nrm * sqrt_c * gamma);
  const float yf = __bfloat162float(y);
  const __nv_bfloat16 s = __float2bfloat16(1.f / (1.f + __expf(-yf)));
  return __float2bfloat16(yf * __bfloat162float(s));
}

// Warp tiling of an M x 96 product with MT m-tiles of 16 rows: WM warps
// along M (one m-tile each; warps past MT idle), 8 / WM along N.
template <int MT>
struct WarpTiling {
  static constexpr int WM = MT > 4 ? 8 : MT;
  static constexpr int WN = NWARPS / WM;
  static constexpr int NT = NB / 8 / WN;  // n-tiles of 8 per warp
};

// acc[NT][4] += the three kernel-column taps (dx) of one kernel row: this
// lane's A row is the staged pixel pix0 + dx of a grid with row stride ld
// (bf16 elements), channels [0, 32) at a; B is the staged weight block
// sW [3][NB][LDA] from output column n0.
template <int NT>
__device__ __forceinline__ void mma_row_taps(float (&acc)[NT][4], const __nv_bfloat16* a, int ld,
                                             int pix0, const __nv_bfloat16* sW, int n0, int lane) {
  const int g = lane >> 2, t4 = lane & 3, kofs = (lane >> 4) * 8;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t af[4];
      ldmatrix_x4(af, a + (size_t)(pix0 + dx) * ld + ks * 16 + kofs);
      const __nv_bfloat16* bp = sW + (dx * NB + n0 + g) * LDA + ks * 16 + t4 * 2;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma16816(acc[nt], af, lds32(bp + nt * 8 * LDA), lds32(bp + nt * 8 * LDA + 8));
    }
  }
}

// x, out: [T,H,W,C]; cache1, cache2, nc1, nc2: [2,H,W,C]; w1, w2: packed
// [3][3][3][C][C] (tap, row, column, out, in); b1, g1, b2, g2: [C] f32.
template <int TW>
__global__ void __launch_bounds__(NTHREADS, 1)
res_block_pair_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ cache1,
                      const __nv_bfloat16* __restrict__ cache2,
                      const __nv_bfloat16* __restrict__ w1, const float* __restrict__ b1,
                      const float* __restrict__ g1, const __nv_bfloat16* __restrict__ w2,
                      const float* __restrict__ b2, const float* __restrict__ g2,
                      __nv_bfloat16* __restrict__ out, __nv_bfloat16* __restrict__ nc1,
                      __nv_bfloat16* __restrict__ nc2, int T, int H, int W, int C) {
  constexpr int GW1 = TW + 4, IN = (TH + 4) * GW1;  // conv1's staged input grid
  constexpr int GW2 = TW + 2, P1 = (TH + 2) * GW2;  // conv1's outputs = conv2's input grid
  constexpr int P2 = TH * TW;                       // conv2's outputs
  using T1 = WarpTiling<(P1 + 15) / 16>;
  using T2 = WarpTiling<P2 / 16>;
  static_assert(P2 % 16 == 0, "conv2 tile rows");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int R = T < 3 ? T : 3;  // ring frames
  const int LDZ = C + 8;
  __nv_bfloat16* sZ = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [R][P1][LDZ]
  __nv_bfloat16* sA = sZ + (size_t)R * P1 * LDZ;                   // [IN][LDA]
  __nv_bfloat16* sW = sA + IN * LDA;                               // [3][NB][LDA]
  float* sN1 = reinterpret_cast<float*>(sW + 3 * NB * LDA);        // [3][IN]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int h0 = blockIdx.y * TH, w0 = blockIdx.x * TW;
  const size_t HW = (size_t)H * W, frame = HW * C;
  const float sqrt_c = sqrtf((float)C);
  const size_t CC = (size_t)C * C;  // one (tap, row, column) block of the packed weights

  // this lane's ldmatrix row in each product, as a staged pixel at (dy, dx) = (0, 0)
  const int wm1 = warp % T1::WM, wn1 = warp / T1::WM;
  const int wm2 = warp % T2::WM, wn2 = warp / T2::WM;
  const bool active1 = wm1 * 16 < P1;
  int p = wm1 * 16 + (lane & 15);
  p = p < P1 ? p : P1 - 1;  // padding rows read a real pixel; their sums are dropped
  const int pix1 = (p / GW2) * GW1 + p % GW2;
  p = wm2 * 16 + (lane & 15);
  const int pix2 = (p / TW) * GW2 + p % TW;

  // stage one weight block: sW[dx][o][c] = w[tap][dy][dx][n0 + o][c0 + c]
  auto stage_w = [&](const __nv_bfloat16* w, int tap, int dy, int n0, int c0) {
    for (int i = tid; i < 3 * NB * (KC / 8); i += NTHREADS) {
      const int dx = i / (NB * (KC / 8)), rem = i % (NB * (KC / 8));
      const int o = rem / (KC / 8), cc = (rem % (KC / 8)) * 8;
      *reinterpret_cast<uint4*>(sW + (dx * NB + o) * LDA + cc) = *reinterpret_cast<const uint4*>(
          w + ((size_t)(tap * 3 + dy) * 3 + dx) * CC + (size_t)(n0 + o) * C + c0 + cc);
    }
  };

  // for T = 1 the first new cache frame of each conv is its old frame 1;
  // nc1's is written while conv1 stages it, nc2's here
  if (T == 1) {
    for (int i = tid; i < P2 * (C / 8); i += NTHREADS) {
      const int q = i / (C / 8), cc = (i % (C / 8)) * 8;
      const int hh = h0 + q / TW, ww = w0 + q % TW;
      if (hh < H && ww < W) {
        const size_t off = ((size_t)hh * W + ww) * C + cc;
        *reinterpret_cast<uint4*>(nc2 + off) = *reinterpret_cast<const uint4*>(cache2 + frame + off);
      }
    }
  }

  for (int t = 0; t < T; ++t) {
    __nv_bfloat16* zt = sZ + (size_t)(t % R) * P1 * LDZ;

    // ---- norms of conv1's x frames over the staged grid (one warp per pixel)
    for (int tau = 0; tau < 3; ++tau) {
      const int v = t + tau;
      if (v < 2) continue;
      const __nv_bfloat16* src = x + (size_t)(v - 2) * frame;
      for (int j = warp; j < IN; j += NWARPS) {
        const int hh = h0 - 2 + j / GW1, ww = w0 - 2 + j % GW1;
        float ss = 0.f;
        if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
          const __nv_bfloat16* px = src + ((size_t)hh * W + ww) * C;
          for (int c = lane * 8; c < C; c += 256) {
            const uint4 u = *reinterpret_cast<const uint4*>(px + c);
            const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              const float f = __bfloat162float(e[k]);
              ss += f * f;
            }
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
        if (lane == 0) sN1[tau * IN + j] = sqrtf(ss) + 1e-12f;
      }
    }

    // ---- 1. conv1 over the halo'd tile, 96 output channels at a time ----
    for (int n0 = 0; n0 < C; n0 += NB) {
      float acc[T1::NT][4];
#pragma unroll
      for (int nt = 0; nt < T1::NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
      for (int tau = 0; tau < 3; ++tau) {
        const int v = t + tau;  // virtual frame: 0, 1 = cache1, >= 2 = x
        const __nv_bfloat16* src = v < 2 ? cache1 + (size_t)v * frame : x + (size_t)(v - 2) * frame;
        const bool normalize = v >= 2;
        // the last two virtual frames are the new cache1; written once
        const bool emit = n0 == 0 && t == T - 1 && tau >= 1;
        for (int c0 = 0; c0 < C; c0 += KC) {
          __syncthreads();  // the previous chunk's fragments are consumed
          for (int i = tid; i < IN * (KC / 8); i += NTHREADS) {
            const int j = i / (KC / 8), cc = (i % (KC / 8)) * 8;
            const int si = j / GW1, sj = j % GW1;
            const int hh = h0 - 2 + si, ww = w0 - 2 + sj;
            uint4 u = make_uint4(0u, 0u, 0u, 0u);
            if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
              const size_t off = ((size_t)hh * W + ww) * C + c0 + cc;
              u = *reinterpret_cast<const uint4*>(src + off);
              if (normalize) {
                __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&u);
                const float nrm = sN1[tau * IN + j];
#pragma unroll
                for (int k = 0; k < 8; ++k)
                  e[k] = norm_silu(__bfloat162float(e[k]), nrm, sqrt_c, __ldg(g1 + c0 + cc + k));
              }
              if (emit && si >= 2 && si < TH + 2 && sj >= 2 && sj < TW + 2)
                *reinterpret_cast<uint4*>(nc1 + (size_t)(v - T) * frame + off) = u;
            }
            *reinterpret_cast<uint4*>(sA + j * LDA + cc) = u;
          }
          for (int dy = 0; dy < 3; ++dy) {
            if (dy > 0) __syncthreads();  // the previous weight block is consumed
            stage_w(w1, tau, dy, n0, c0);
            __syncthreads();
            if (active1)
              mma_row_taps<T1::NT>(acc, sA, LDA, pix1 + dy * GW1, sW, wn1 * T1::NT * 8, lane);
          }
        }
      }
      // y = bf16(acc + b1) into the ring (rows past P1 are padding)
      if (active1) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = wm1 * 16 + g + hh * 8;
          if (row >= P1) continue;
#pragma unroll
          for (int nt = 0; nt < T1::NT; ++nt) {
            const int o = n0 + wn1 * T1::NT * 8 + nt * 8 + t4 * 2;
            *reinterpret_cast<__nv_bfloat162*>(zt + (size_t)row * LDZ + o) =
                __floats2bfloat162_rn(acc[nt][hh * 2] + __ldg(b1 + o),
                                      acc[nt][hh * 2 + 1] + __ldg(b1 + o + 1));
          }
        }
      }
    }
    __syncthreads();

    // ---- 2. z = norm2 + SiLU of y in place; 0 outside the image; emit nc2
    const int nc2_idx = t - (T - 2);  // >= 0 for the last two frames
    for (int q = warp; q < P1; q += NWARPS) {
      const int qi = q / GW2, qj = q % GW2;
      const int hh = h0 - 1 + qi, ww = w0 - 1 + qj;
      __nv_bfloat16* zp = zt + (size_t)q * LDZ;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W) {
        float ss = 0.f;
        for (int c = lane * 8; c < C; c += 256) {
          const uint4 u = *reinterpret_cast<const uint4*>(zp + c);
          const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float f = __bfloat162float(e[k]);
            ss += f * f;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
        const float nrm = sqrtf(ss) + 1e-12f;
        const bool emit = nc2_idx >= 0 && qi >= 1 && qi <= TH && qj >= 1 && qj <= TW;
        for (int c = lane * 8; c < C; c += 256) {
          uint4 u = *reinterpret_cast<const uint4*>(zp + c);
          __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
          for (int k = 0; k < 8; ++k)
            e[k] = norm_silu(__bfloat162float(e[k]), nrm, sqrt_c, __ldg(g2 + c + k));
          *reinterpret_cast<uint4*>(zp + c) = u;
          if (emit)
            *reinterpret_cast<uint4*>(nc2 + (size_t)nc2_idx * frame + ((size_t)hh * W + ww) * C + c) = u;
        }
      } else {
        for (int c = lane * 8; c < C; c += 256)
          *reinterpret_cast<uint4*>(zp + c) = make_uint4(0u, 0u, 0u, 0u);
      }
    }

    // ---- 3. conv2 over the output tile, 96 output channels at a time ----
    for (int n0 = 0; n0 < C; n0 += NB) {
      float acc[T2::NT][4];
#pragma unroll
      for (int nt = 0; nt < T2::NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
      for (int tau = 0; tau < 3; ++tau) {
        const int v = t + tau;  // virtual frame: 0, 1 = cache2, >= 2 = z (the ring)
        for (int c0 = 0; c0 < C; c0 += KC) {
          const __nv_bfloat16* a;
          int ld;
          if (v < 2) {
            __syncthreads();  // the previous chunk's fragments are consumed
            const __nv_bfloat16* src = cache2 + (size_t)v * frame;
            for (int i = tid; i < P1 * (KC / 8); i += NTHREADS) {
              const int j = i / (KC / 8), cc = (i % (KC / 8)) * 8;
              const int hh = h0 - 1 + j / GW2, ww = w0 - 1 + j % GW2;
              uint4 u = make_uint4(0u, 0u, 0u, 0u);
              if (hh >= 0 && hh < H && ww >= 0 && ww < W)
                u = *reinterpret_cast<const uint4*>(src + ((size_t)hh * W + ww) * C + c0 + cc);
              *reinterpret_cast<uint4*>(sA + j * LDA + cc) = u;
            }
            a = sA;
            ld = LDA;
          } else {
            a = sZ + (size_t)((v - 2) % R) * P1 * LDZ + c0;
            ld = LDZ;
          }
          for (int dy = 0; dy < 3; ++dy) {
            __syncthreads();  // the previous weight block is consumed (and z is ready)
            stage_w(w2, tau, dy, n0, c0);
            __syncthreads();
            mma_row_taps<T2::NT>(acc, a, ld, pix2 + dy * GW2, sW, wn2 * T2::NT * 8, lane);
          }
        }
      }
      // out = bf16(acc + b2) + x, in bf16
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = wm2 * 16 + g + hh * 8;
        const int oh = h0 + row / TW, ow = w0 + row % TW;
        if (oh >= H || ow >= W) continue;
        const size_t base = (size_t)t * frame + ((size_t)oh * W + ow) * C;
#pragma unroll
        for (int nt = 0; nt < T2::NT; ++nt) {
          const int o = n0 + wn2 * T2::NT * 8 + nt * 8 + t4 * 2;
          const __nv_bfloat162 y = __floats2bfloat162_rn(acc[nt][hh * 2] + __ldg(b2 + o),
                                                         acc[nt][hh * 2 + 1] + __ldg(b2 + o + 1));
          const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(x + base + o);
          *reinterpret_cast<__nv_bfloat162*>(out + base + o) = __floats2bfloat162_rn(
              __low2float(y) + __low2float(r), __high2float(y) + __high2float(r));
        }
      }
    }
    __syncthreads();  // the ring slot of frame t + 1 is read no more
  }
}

size_t smem_bytes(int TW, int T, int C) {
  const int R = T < 3 ? T : 3;
  const size_t p1 = (size_t)(TH + 2) * (TW + 2), in = (size_t)(TH + 4) * (TW + 4);
  return 2 * R * p1 * (C + 8) + 2 * in * LDA + 2 * 3 * NB * LDA + 4 * 3 * in;
}

template <int TW>
int launch(const void* x, const void* cache1, const void* cache2, const void* w1, const void* b1,
           const void* g1, const void* w2, const void* b2, const void* g2, void* out, void* nc1,
           void* nc2, int T, int H, int W, int C, cudaStream_t stream) {
  const size_t smem = smem_bytes(TW, T, C);
  cudaError_t err = cudaFuncSetAttribute(res_block_pair_kernel<TW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
  res_block_pair_kernel<TW><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(cache1),
      static_cast<const __nv_bfloat16*>(cache2), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(b1), static_cast<const float*>(g1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const float*>(b2),
      static_cast<const float*>(g2), static_cast<__nv_bfloat16*>(out),
      static_cast<__nv_bfloat16*>(nc1), static_cast<__nv_bfloat16*>(nc2), T, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out: [T,H,W,C] bf16; cache1, cache2, nc1, nc2: [2,H,W,C] bf16; w1, w2:
// [3][3][3][C][C] bf16 (ops/vae_conv.py::pack_weights); b1, g1, b2, g2: [C]
// f32; C % 96 == 0; TW: the output tile's width, 8 or 4 (8 rows).
int longlive_res_block_pair(const void* x, const void* cache1, const void* cache2,
                            const void* w1, const void* b1, const void* g1, const void* w2,
                            const void* b2, const void* g2, void* out, void* nc1, void* nc2,
                            int T, int H, int W, int C, int TW, void* stream) {
  if (C % NB != 0 || (TW != 8 && TW != 4) || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return TW == 8 ? launch<8>(x, cache1, cache2, w1, b1, g1, w2, b2, g2, out, nc1, nc2, T, H, W, C, st)
                 : launch<4>(x, cache1, cache2, w1, b1, g1, w2, b2, g2, out, nc1, nc2, T, H, W, C, st);
}

const char* longlive_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
