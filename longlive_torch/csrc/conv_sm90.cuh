// The bf16 causal-conv GEMM of the streaming VAE decoder on Hopper
// (sm_90a), shared by K2 (causal_conv.cu) and K6 (res_block_pair.cu): the
// input pass that normalises each conv input element once, and the TMA-fed,
// warp-specialised wgmma implicit GEMM, with its epilogue as a template
// parameter (K2's bias + residual; K6's conv1 adds norm2 + SiLU over each
// pixel's whole channel vector).  The design is described in causal_conv.cu.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"  // mbarriers, TMA, wgmma descriptors, the tensor-map entry

namespace {

// silu(rms_norm) of one element with the decoder's rounding points:
// y = bf16(x / nrm * sqrt(C) * gamma), s = bf16(sigmoid(y)), bf16(y * s).
__device__ __forceinline__ __nv_bfloat16 norm_silu(float x, float nrm, float sqrt_c, float gamma) {
  const __nv_bfloat16 y = __float2bfloat16(x / nrm * sqrt_c * gamma);
  const float yf = __bfloat162float(y);
  const __nv_bfloat16 s = __float2bfloat16(1.f / (1.f + __expf(-yf)));
  return __float2bfloat16(yf * __bfloat162float(s));
}

// ---------------------------------------------------------------------------
// The conv's input, once per element.  Over the virtual frames v = v0 ..
// T + 1 of [cache ++ x] (v < 2: cache frame v; v >= 2: x frame v - 2): with
// gamma, x frames are normalised (norm + SiLU) into xn [T,H,W,C]; frames
// v >= T (the last two) go to the new cache nx [2,H,W,C] at slot v - T,
// normalised where they are x frames with gamma, as they are otherwise.
// Four lanes per pixel (8 channels each, 32 apart), 64 pixels per
// 256-thread block.  LIB names the library that launches it (2: K2, 6: K6),
// so a profile tells their launches apart.

template <int LIB>
__global__ void __launch_bounds__(256)
conv_input_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ cache,
                  const float* __restrict__ gamma, __nv_bfloat16* __restrict__ xn,
                  __nv_bfloat16* __restrict__ nx, int T, int HW, int C, int v0) {
  const long long q = (long long)blockIdx.x * 64 + (threadIdx.x >> 2);
  if (q >= (long long)(T + 2 - v0) * HW) return;
  const int v = v0 + (int)(q / HW);
  const long long pix = q % HW;
  const int c_first = (threadIdx.x & 3) * 8;
  const __nv_bfloat16* src = (v < 2 ? cache + (v * HW + pix) * C : x + ((v - 2) * HW + pix) * C);
  __nv_bfloat16* to_cache = v >= T ? nx + ((v - T) * HW + pix) * C : nullptr;
  if (gamma == nullptr || v < 2) {  // a plain copy into the new cache
    for (int c = c_first; c < C; c += 32)
      *reinterpret_cast<uint4*>(to_cache + c) = *reinterpret_cast<const uint4*>(src + c);
    return;
  }
  float ss = 0.f;
  for (int c = c_first; c < C; c += 32) {
    uint4 u = *reinterpret_cast<const uint4*>(src + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float f = __bfloat162float(e[i]);
      ss += f * f;
    }
  }
  ss += __shfl_xor_sync(0xffffffffu, ss, 1);
  ss += __shfl_xor_sync(0xffffffffu, ss, 2);
  const float nrm = sqrtf(ss) + 1e-12f;
  const float sqrt_c = sqrtf((float)C);
  __nv_bfloat16* to_xn = xn + ((v - 2) * HW + pix) * C;
  for (int c = c_first; c < C; c += 32) {
    uint4 u = *reinterpret_cast<const uint4*>(src + c);
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = norm_silu(__bfloat162float(e[i]), nrm, sqrt_c, __ldg(gamma + c + i));
    *reinterpret_cast<uint4*>(to_xn + c) = u;
    if (to_cache != nullptr) *reinterpret_cast<uint4*>(to_cache + c) = u;
  }
}

// The first virtual frame conv_input_kernel visits: with a norm every x
// frame (from 2, or T for T < 2, where the cache's frame 1 is copied
// first); without one only the last two, the new cache.
template <int LIB>
int conv_input(const void* x, const void* cache, const void* gamma, void* xn, void* nx, int T,
               int H, int W, int C, cudaStream_t stream) {
  const int v0 = gamma != nullptr ? (T < 2 ? T : 2) : T;
  const long long pixels = (long long)(T + 2 - v0) * H * W;
  conv_input_kernel<LIB><<<(unsigned)((pixels + 63) / 64), 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(cache),
      static_cast<const float*>(gamma), static_cast<__nv_bfloat16*>(xn),
      static_cast<__nv_bfloat16*>(nx), T, H * W, C, v0);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The conv, TMA -> shared-memory ring -> wgmma.

constexpr int CONV_THREADS = 288;  // consumer warpgroups 0-1 (warps 0-7), producer warp 8

// m64nNk16, bf16 x bf16 -> f32, A and B K-major from shared memory:
// D += A B (the predicate scale-d is set).
__device__ __forceinline__ void wgmma_n96(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_n192(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, %96, %97, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1));
}

template <int NT>
__device__ __forceinline__ void wgmma_tile(float* d, uint64_t da, uint64_t db) {
  if constexpr (NT == 96) wgmma_n96(d, da, db);
  else wgmma_n192(d, da, db);
}

// The shape of one conv launch and its tiling.
struct ConvShape {
  int T, H, W, C, O, kh, kw, bh, bw, tiles_w, n_pix, a_bytes, stages;
};

// What an epilogue reads and writes: bias [O] f32 or null; residual and
// out [T,H,W,O] (residual may be null); gamma [O] and cache_out [2,H,W,O]
// for the norm epilogue only.
struct ConvOut {
  const float* bias;
  const __nv_bfloat16* residual;
  __nv_bfloat16* out;
  const float* gamma;
  __nv_bfloat16* cache_out;
};

// The accumulator row (within the CTA's M tile) of this thread's half hh
// of its m64 tile j; the column of pair n is 8 n + 2 (lane & 3).
template <int MT>
__device__ __forceinline__ int acc_row(int j, int hh) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp >> 2) * 64 * MT + j * 64 + (warp & 3) * 16 + (lane >> 2) + hh * 8;
}

// K2's epilogue: bf16(acc + bias) [+ residual], rows outside the frame
// dropped.
struct BiasResidual {
  template <int NT, int MT>
  __device__ static void store(float (&acc)[MT][NT / 2], const ConvShape& s, const ConvOut& e,
                               int t, int h0, int w0, int o0) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < MT; ++j) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = acc_row<MT>(j, hh);
        const int h = h0 + r / s.bw, w = w0 + r % s.bw;
        if (h >= s.H || w >= s.W) continue;
        const size_t rowoff = (((size_t)t * s.H + h) * s.W + w) * s.O;
#pragma unroll
        for (int n = 0; n < NT / 8; ++n) {
          const int o = o0 + n * 8 + (lane & 3) * 2;
          float v0 = acc[j][n * 4 + hh * 2], v1 = acc[j][n * 4 + hh * 2 + 1];
          if (e.bias != nullptr) {
            v0 += __ldg(e.bias + o);
            v1 += __ldg(e.bias + o + 1);
          }
          __nv_bfloat162 y = __floats2bfloat162_rn(v0, v1);
          if (e.residual != nullptr) {  // read-only loads: ConvOut's pointers may alias
            const __nv_bfloat162 rr =
                __ldg(reinterpret_cast<const __nv_bfloat162*>(e.residual + rowoff + o));
            y = __floats2bfloat162_rn(__low2float(y) + __low2float(rr),
                                      __high2float(y) + __high2float(rr));
          }
          *reinterpret_cast<__nv_bfloat162*>(e.out + rowoff + o) = y;
        }
      }
    }
  }
};

// The consumer warpgroups of causal_conv_wgmma_kernel.
template <int NT, int MT, int KCH, class Epi>
__device__ __forceinline__ void consumer(uint32_t full, uint32_t empty, uint32_t base,
                                         int stage_bytes, const ConvShape& sh, const ConvOut& eo,
                                         int n_s, int n_tiles) {
  constexpr int ROW = KCH * 2;
  const int wg = (threadIdx.x >> 5) >> 2;
  // warpgroup wg owns rows 64 MT wg .. 64 MT (wg + 1) - 1 of the
  // tile, as MT m64 tiles
  float acc[MT][NT / 2];
  int s = 0;
  uint32_t round = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int e = 0; e < NT / 2; ++e) acc[j][e] = 0.f;
    int prev = 0;
    for (int i = 0; i < n_s; ++i) {
      mbar_wait(full + 8 * s, round & 1);
      const uint32_t a = base + s * stage_bytes + wg * (64 * MT * ROW);
      const uint32_t b = base + s * stage_bytes + sh.a_bytes;
      wgmma_fence();
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        if (dy >= sh.kh) break;
#pragma unroll
        for (int k = 0; k < KCH / 16; ++k) {  // 16 channels = 32 bytes along the row
          const uint64_t db = smem_desc<KCH>(b + dy * NT * ROW + 32 * k);
#pragma unroll
          for (int j = 0; j < MT; ++j)
            wgmma_tile<NT>(acc[j], smem_desc<KCH>(a + (dy * sh.bw + 64 * j) * ROW + 32 * k), db);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done: release its stage
      if (i > 0 && (threadIdx.x & 127) == 0) mbar_arrive(empty + 8 * prev);
      prev = s;
      if (++s == sh.stages) {
        s = 0;
        ++round;
      }
    }
    wgmma_wait<0>();
    if ((threadIdx.x & 127) == 0) mbar_arrive(empty + 8 * prev);

    const int pix = tile % sh.n_pix, t = (tile / sh.n_pix) % sh.T;
    const int o0 = tile / (sh.n_pix * sh.T) * NT;
    Epi::template store<NT, MT>(acc, sh, eo, t, pix / sh.tiles_w * sh.bh,
                                pix % sh.tiles_w * sh.bw, o0);
  }
}

// xmap: the conv input frames [T,H,W,C] (xn, or x without a norm); cmap:
// the cache [2,H,W,C]; both with box {KCH, bw, bh + kh - 1, 1}.  wmap: the
// packed weights [3][kh][kw][O][C] as {C, kw*O, kh, 3} with box {KCH, NT,
// kh, 1}.  A CTA walks over tiles (pixel box, frame, output-channel tile),
// pixel boxes fastest; a stage holds one (temporal tap, kernel column,
// channel chunk): the box with its kh - 1 halo rows and the kh weight
// tiles, and the kh kernel rows are three views of the box, bw rows apart.
template <int NT, int MT, int KCH, class Epi>
__global__ void __launch_bounds__(CONV_THREADS, 1)
causal_conv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap cmap,
                         const __grid_constant__ CUtensorMap wmap, const ConvShape sh,
                         const ConvOut eo) {
  constexpr int ROW = KCH * 2;  // bytes of one staged pixel or weight row
  extern __shared__ uint8_t smem_raw[];
  const int stage_bytes = sh.a_bytes + sh.kh * NT * ROW;  // a multiple of 1024
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms are aligned
  const uint32_t full = base + sh.stages * stage_bytes;         // mbarriers, 8 bytes each
  const uint32_t empty = full + sh.stages * 8;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nc = sh.C / KCH;
  const int n_s = 3 * sh.kw * nc;  // stages per tile
  const int n_tiles = sh.n_pix * sh.T * (sh.O / NT);

  if (threadIdx.x == 0) {
    for (int s = 0; s < sh.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 8) {  // producer warp: one thread issues every TMA load
    if (lane == 0) {
      const int kh = sh.kh, kw = sh.kw;
      const uint32_t tx = ((sh.bh + kh - 1) * sh.bw + kh * NT) * ROW;  // overhanging boxes included
      int s = 0;
      uint32_t round = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int pix = tile % sh.n_pix, t = (tile / sh.n_pix) % sh.T;
        const int o0 = tile / (sh.n_pix * sh.T) * NT;
        const int h0 = pix / sh.tiles_w * sh.bh - kh / 2, w0 = pix % sh.tiles_w * sh.bw - kw / 2;
        for (int i = 0; i < n_s; ++i) {
          if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
          const int c0 = (i % nc) * KCH, dx = (i / nc) % kw, vf = t + i / (nc * kw);
          const uint32_t dst = base + s * stage_bytes;
          const uint32_t bar = full + 8 * s;
          mbar_expect_tx(bar, tx);
          tma_load_4d(dst, vf < 2 ? &cmap : &xmap, bar, c0, w0 + dx, h0, vf < 2 ? vf : vf - 2);
          tma_load_4d(dst + sh.a_bytes, &wmap, bar, c0, dx * sh.O + o0, 0, vf - t);
          if (++s == sh.stages) {
            s = 0;
            ++round;
          }
        }
      }
    }
  } else {
    consumer<NT, MT, KCH, Epi>(full, empty, base, stage_bytes, sh, eo, n_s, n_tiles);
  }
}

// Shared memory of one stage's box of `row` bytes per pixel with its halo
// rows, rounded to 1024.
int box_bytes(int bh, int bw, int kh, int row) {
  return ((bh + kh - 1) * bw * row + 1023) / 1024 * 1024;
}

// The dynamic shared memory of a ring of `stages` stages of one box (rows
// of `row` bytes) and kh x nt weight rows each, with its barriers and 1024
// bytes of alignment.
int ring_bytes(int bh, int bw, int kh, int nt, int row, int stages) {
  return 1024 + stages * (box_bytes(bh, bw, kh, row) + kh * nt * row + 16);
}

// The checks every bf16 conv launch passes: a bh x bw box of 128 mt
// pixels (bw a multiple of 8), kc channels per K step dividing C, nt
// dividing O, kernel rows and columns 1 or 3, and a ring of >= 2 stages
// that fits a CTA's shared memory.
bool conv_tiling_ok(int C, int O, int kh, int kw, int bh, int bw, int kc, int nt, int mt,
                    int stages, int T) {
  return !(mt < 1 || kc < 1 || nt < 1 || bh < 1 || bw < 8 || bw % 8 || bh * bw != 128 * mt ||
           bw > 256 || bh + kh - 1 > 256 || C % kc || O % nt || (kh != 1 && kh != 3) ||
           (kw != 1 && kw != 3) || stages < 2 || T < 1 ||
           ring_bytes(bh, bw, kh, nt, kc * 2, stages) > 232448);
}

// Encodes the three tensor maps and launches causal_conv_wgmma_kernel on
// min(tiles, SMs) persistent CTAs.
template <int NT, int MT, int KCH, class Epi>
int launch_conv(const void* x, const void* cache, const void* w, const ConvOut& eo, int T, int H,
                int W, int C, int O, int kh, int kw, int bh, int bw, int stages,
                cudaStream_t stream) {
  const cuuint64_t px = (cuuint64_t)C * 2;  // bytes per pixel
  const cuuint64_t xdims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)T};
  const cuuint64_t cdims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, 2};
  const cuuint64_t fstrides[3] = {px, px * W, px * W * H};
  const cuuint32_t fbox[4] = {(cuuint32_t)KCH, (cuuint32_t)bw, (cuuint32_t)(bh + kh - 1), 1};
  const cuuint64_t wdims[4] = {(cuuint64_t)C, (cuuint64_t)kw * O, (cuuint64_t)kh, 3};
  const cuuint64_t wstrides[3] = {px, px * kw * O, px * kw * O * kh};
  const cuuint32_t wbox[4] = {(cuuint32_t)KCH, (cuuint32_t)NT, (cuuint32_t)kh, 1};
  CUtensorMap xmap, cmap, wmap;
  if (!encode_map(&xmap, x, xdims, fstrides, fbox) ||
      !encode_map(&cmap, cache, cdims, fstrides, fbox) ||
      !encode_map(&wmap, w, wdims, wstrides, wbox))
    return (int)cudaErrorInvalidValue;
  const int smem = ring_bytes(bh, bw, kh, NT, KCH * 2, stages);
  auto kernel = causal_conv_wgmma_kernel<NT, MT, KCH, Epi>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + bw - 1) / bw, n_pix = (H + bh - 1) / bh * tiles_w;
  const int n_tiles = n_pix * T * (O / NT);
  const ConvShape sh{T, H, W, C, O, kh, kw, bh, bw, tiles_w, n_pix,
                     box_bytes(bh, bw, kh, KCH * 2), stages};
  kernel<<<n_tiles < sms ? n_tiles : sms, CONV_THREADS, smem, stream>>>(xmap, cmap, wmap, sh, eo);
  return (int)cudaGetLastError();
}

}  // namespace
