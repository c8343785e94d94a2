// The forward flash-attention pipeline shared by K4's forward
// (flash_attention_train.cu) and K3 (flash_attention_masked.cu): a
// warp-specialised CTA of 128 query rows of one head, whose producer warp
// stages Q once and streams K/V tiles of 128 tokens through a ring of
// shared-memory stages, and whose two consumer warpgroups (64 rows each)
// run S = Q K^T on wgmma, the online softmax in registers and O += P V with
// P from registers.  The kernels differ in which kv tiles they walk, how
// they mask (and scale) S, and their epilogues; those stay in each source.
// Operands are [B, S, N, 128] bf16 tensor maps (rows_map): a tile of R
// rows is two 64-column boxes of [R][128 bytes], swizzled 128B.

#pragma once

#include "sm90.cuh"

namespace {

constexpr int FWD_D = 128;              // head dim
constexpr int FWD_ROWB = FWD_D * 2;     // bytes of one token row of one head
constexpr int FWD_BM = 128;             // query rows per CTA, 64 per consumer warpgroup
constexpr int FWD_BN = 128;             // kv tokens per tile (the m64n128 products)
constexpr int FWD_KV = FWD_BN * FWD_ROWB;  // one K or V tile
constexpr int FWD_STAGE = 2 * FWD_KV;      // a stage holds a K and a V tile
constexpr float NEG = -1e30f;  // a masked logit: finite, so a masked tile cannot put NaN into the max

// The producer's one thread: Q's rows [q0, q0 + 128) into sQ (on qbar),
// then for i < nwalk the K and V tiles of kv tile tile_of(i) into stage
// i % STAGES (on its full barrier), each stage reused once both consumer
// warpgroups released it (its empty barrier).
template <int STAGES, class TileOf>
__device__ __forceinline__ void fwd_produce(const CUtensorMap* qmap, const CUtensorMap* kmap,
                                            const CUtensorMap* vmap, uint32_t sQ, uint32_t ring,
                                            uint32_t qbar, uint32_t full, uint32_t empty, int q0,
                                            int n, int b, int nwalk, TileOf tile_of) {
  mbar_expect_tx(qbar, FWD_BM * FWD_ROWB);
  load_rows<FWD_BM>(sQ, qmap, qbar, q0, n, b);
  for (int i = 0; i < nwalk; ++i) {
    const int s = i % STAGES, round = i / STAGES;
    if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
    const int kv0 = tile_of(i) * FWD_BN;
    const uint32_t dst = ring + s * FWD_STAGE;
    mbar_expect_tx(full + 8 * s, FWD_STAGE);
    load_rows<FWD_BN>(dst, kmap, full + 8 * s, kv0, n, b);
    load_rows<FWD_BN>(dst + FWD_KV, vmap, full + 8 * s, kv0, n, b);
  }
}

// S = Q K^T of consumer warpgroup wg: its 64 query rows against the K tile
// at kt, 64 x 128 float32 in the m64n128 accumulator layout (sc[4 j + c]:
// row g, column 8 j + 2 tq + c; sc[4 j + 2 + c]: row g + 8).
__device__ __forceinline__ void fwd_scores(float* sc, uint32_t sQ, int wg, uint32_t kt) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < FWD_D / 16; ++kk)
    wgmma_ss_n128(sc, desc_k<FWD_BM>(sQ, wg * 64, kk), desc_k<FWD_BN>(kt, 0, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
}

// One tile of the online softmax over the masked logits sc of rows g and
// g + 8 (running max m, per-thread partial row sums l), then O += P V with
// the V tile at vt: P = exp(S - m) rounded to bf16 as the A fragments of
// P V, while the row sums take the unrounded P.
__device__ __forceinline__ void fwd_softmax_pv(float* sc, float* o, float& m0, float& m1,
                                               float& l0, float& l1, uint32_t vt) {
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int j = 0; j < FWD_BN / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float a0 = __expf(m0 - mx0), a1 = __expf(m1 - mx1);
  m0 = mx0;
  m1 = mx1;

  uint32_t pf[FWD_BN / 16][4];
  float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
  for (int j = 0; j < FWD_BN / 8; ++j) {
    const float p0 = __expf(sc[4 * j] - m0), p1 = __expf(sc[4 * j + 1] - m0);
    const float p2 = __expf(sc[4 * j + 2] - m1), p3 = __expf(sc[4 * j + 3] - m1);
    rs0 += p0 + p1;
    rs1 += p2 + p3;
    pf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(p0, p1);
    pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
  }
  l0 = l0 * a0 + rs0;
  l1 = l1 * a1 + rs1;
#pragma unroll
  for (int j = 0; j < FWD_D / 8; ++j) {
    o[4 * j] *= a0;
    o[4 * j + 1] *= a0;
    o[4 * j + 2] *= a1;
    o[4 * j + 3] *= a1;
  }

  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < FWD_BN / 16; ++kb) wgmma_rs_n128(o, pf[kb], desc_mn<FWD_BN>(vt, kb));
  wgmma_commit();
  wgmma_wait<0>();
}

}  // namespace
