// A whole no-shortcut residual block of the streaming VAE decoder in one
// call: out = conv2(silu(norm2(conv1(silu(norm1(x)))))) + x, both causal
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
// activations, so tensor-core throughput bounds it.
//
// Why the TPU design does not carry over: the TPU kernel keeps z (conv1's
// normalised output) in VMEM and recomputes conv1's halo.  Here a 128-pixel
// tile's halo of z over 384 channels and a 3-frame ring would take ~415 KB
// of shared memory against 227 KB, and a CTA that owns all C channels of
// a small tile restages both convs' weights per tile.  z's round trip
// through L2 / HBM costs ~0.2 ms at the 96-wide stage against a 1.6 ms
// bound, so z goes to memory and the tensor cores get large tiles.
//
// Design: one C entry point, three or four launches on the stream, all of
// conv_sm90.cuh (K2's input pass and its TMA-fed, warp-specialised wgmma
// implicit GEMM):
//   1. conv_input_kernel: norm1 + SiLU of x once per element into a scratch
//      xn, and the new cache1;
//   2. conv1 on the GEMM with a K6 epilogue (BiasNormSilu) where one CTA's N
//      covers C (C = 96: m64n96, C = 192: m64n192): y = bf16(acc + b1), then
//      norm2 + SiLU over each pixel's whole channel vector (a row's sum of
//      squares is a shuffle over the 4 lanes that hold it), z and the new
//      cache2 written; y is never written.  At wider C (384) a warpgroup's
//      N cannot cover C, and two warpgroups on the same 64 rows would
//      restage 384 weight rows per 64 pixels: conv1 takes K2's epilogue
//      into a scratch y and the input pass runs norm2 over it (y's round
//      trip is ~2% of the conv's time there);
//   3. conv2 on the GEMM with K2's epilogue: + b2, bf16, + x.
// The tiles come from ops/vae_conv.py::pair_tiles.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_sm90.cuh"  // the input pass, the GEMM and K2's epilogue

namespace {

// norm_silu's rounding points with cheaper float steps, for the GEMM's
// epilogue, which no other work overlaps: the row's reciprocal norm once
// (x * inv against x / nrm) and an approximate reciprocal in the sigmoid
// (each within two float ulps before the bf16 roundings).
__device__ __forceinline__ __nv_bfloat16 norm_silu_fast(float x, float inv, float sqrt_c,
                                                        float gamma) {
  const float y = __bfloat162float(__float2bfloat16(x * inv * sqrt_c * gamma));
  const float s = __bfloat162float(__float2bfloat16(__fdividef(1.f, 1.f + __expf(-y))));
  return __float2bfloat16(y * s);
}

// K6's conv1 epilogue (NT == O == C: the CTA holds each pixel's whole
// channel vector): y = bf16(acc + bias), z = norm + SiLU of y with gamma
// into out, and into cache_out at slot t - (T - 2) for the last two frames.
struct BiasNormSilu {
  template <int NT, int MT>
  __device__ static void store(float (&acc)[MT][NT / 2], const ConvShape& s, const ConvOut& e,
                               int t, int h0, int w0, int) {
    const int lane = threadIdx.x & 31;
    const float sqrt_c = sqrtf((float)NT);
    const int slot = t - (s.T - 2);
#pragma unroll
    for (int j = 0; j < MT; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float ss = 0.f;
#pragma unroll
        for (int n = 0; n < NT / 8; ++n) {
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            float& v = acc[j][n * 4 + hh * 2 + k];
            v = __bfloat162float(__float2bfloat16(v + __ldg(e.bias + n * 8 + (lane & 3) * 2 + k)));
            ss += v * v;
          }
        }
        ss += __shfl_xor_sync(0xffffffffu, ss, 1);
        ss += __shfl_xor_sync(0xffffffffu, ss, 2);
        const int r = acc_row<MT>(j, hh);
        const int h = h0 + r / s.bw, w = w0 + r % s.bw;
        if (h >= s.H || w >= s.W) continue;
        const float inv = 1.f / (sqrtf(ss) + 1e-12f);
        const size_t pix = ((size_t)h * s.W + w) * NT;
        __nv_bfloat16* z = e.out + (size_t)t * s.H * s.W * NT + pix;
        __nv_bfloat16* zc = slot >= 0 ? e.cache_out + (size_t)slot * s.H * s.W * NT + pix : nullptr;
#pragma unroll
        for (int n = 0; n < NT / 8; ++n) {
          const int o = n * 8 + (lane & 3) * 2;
          __nv_bfloat162 zz;
          zz.x = norm_silu_fast(acc[j][n * 4 + hh * 2], inv, sqrt_c, __ldg(e.gamma + o));
          zz.y = norm_silu_fast(acc[j][n * 4 + hh * 2 + 1], inv, sqrt_c, __ldg(e.gamma + o + 1));
          *reinterpret_cast<__nv_bfloat162*>(z + o) = zz;
          if (zc != nullptr) *reinterpret_cast<__nv_bfloat162*>(zc + o) = zz;
        }
      }
    }
  }
};

// K2's epilogue under K6's own name (its launches read as K6's in a
// profile): conv2's bias + residual, or conv1's bias before a norm pass.
struct PairResidual : BiasResidual {};

// One conv of the block on the GEMM: (nt, mt, kc) must be an instantiation
// below, NORM only with nt == C.
template <bool NORM>
int pair_conv(const void* x, const void* cache, const void* w, const ConvOut& eo, int T, int H,
              int W, int C, int bh, int bw, int kc, int nt, int mt, int stages, cudaStream_t st) {
  if (!conv_tiling_ok(C, C, 3, 3, bh, bw, kc, nt, mt, stages, T) || (NORM && nt != C))
    return (int)cudaErrorInvalidValue;
#define LONGLIVE_PAIR_CONV(NT, MT, KC, EPI)                                                    \
  if (nt == NT && mt == MT && kc == KC)                                                       \
    return launch_conv<NT, MT, KC, EPI>(x, cache, w, eo, T, H, W, C, C, 3, 3, bh, bw, stages, st);
  if constexpr (NORM) {
    LONGLIVE_PAIR_CONV(96, 2, 32, BiasNormSilu) LONGLIVE_PAIR_CONV(192, 1, 32, BiasNormSilu)
  } else {
    LONGLIVE_PAIR_CONV(96, 2, 32, PairResidual) LONGLIVE_PAIR_CONV(96, 1, 64, PairResidual)
  }
#undef LONGLIVE_PAIR_CONV
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, out: [T,H,W,C] bf16; cache1, cache2, nc1, nc2: [2,H,W,C] bf16; w1, w2:
// [3][3][3][C][C] bf16 (ops/vae_conv.py::pack_weights); b1, g1, b2, g2: [C]
// f32; C % 96 == 0.  Scratch [T,H,W,C] bf16: xn (conv1's input) and z
// (conv2's); y (conv1's output) only where conv1 does not take norm2 in
// its epilogue (t1[3] != C), else null.  t1, t2: conv1's and conv2's tiles
// (bh, bw, kc, nt, mt, stages) from ops/vae_conv.py::pair_tiles.
int longlive_res_block_pair(const void* x, const void* cache1, const void* cache2,
                            const void* w1, const void* b1, const void* g1, const void* w2,
                            const void* b2, const void* g2, void* out, void* nc1, void* nc2,
                            void* xn, void* z, void* y, int T, int H, int W, int C,
                            const int* t1, const int* t2, void* stream) {
  if (C % 96 != 0 || T < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool fused = t1[3] == C;
  if (!fused && y == nullptr) return (int)cudaErrorInvalidValue;
  int err = conv_input<6>(x, cache1, g1, xn, nc1, T, H, W, C, st);
  if (err) return err;
  const float* fb1 = static_cast<const float*>(b1);
  auto z16 = static_cast<__nv_bfloat16*>(z);
  if (fused) {
    const ConvOut eo{fb1, nullptr, z16, static_cast<const float*>(g2),
                     static_cast<__nv_bfloat16*>(nc2)};
    err = pair_conv<true>(xn, cache1, w1, eo, T, H, W, C, t1[0], t1[1], t1[2], t1[3], t1[4],
                          t1[5], st);
    if (!err && T == 1) {  // the new cache2's frame 0 is the old one's frame 1
      const size_t frame = (size_t)H * W * C * 2;
      err = (int)cudaMemcpyAsync(nc2, static_cast<const char*>(cache2) + frame, frame,
                                 cudaMemcpyDeviceToDevice, st);
    }
  } else {
    const ConvOut eo{fb1, nullptr, static_cast<__nv_bfloat16*>(y), nullptr, nullptr};
    err = pair_conv<false>(xn, cache1, w1, eo, T, H, W, C, t1[0], t1[1], t1[2], t1[3], t1[4],
                           t1[5], st);
    if (!err) err = conv_input<6>(y, cache2, g2, z, nc2, T, H, W, C, st);  // norm2 + SiLU
  }
  if (err) return err;
  const ConvOut eo{static_cast<const float*>(b2), static_cast<const __nv_bfloat16*>(x),
                   static_cast<__nv_bfloat16*>(out), nullptr, nullptr};
  return pair_conv<false>(z, cache2, w2, eo, T, H, W, C, t2[0], t2[1], t2[2], t2[3], t2[4],
                          t2[5], st);
}

const char* longlive_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
