// The tensor-core attention tile over an int8 KV pool: K4's int8 branch
// at CB > 1 with bf16 queries (csrc/paged_attention.cu, "mma_int8").
//
// Replaces the `quant` branch of llmss_tpu/ops/pallas_ragged.py::_kernel
// (:80-87, :144-145, :157, :163-168, and the finalize loop's fresh keys):
// each cache score times its slot's K scale before the mask, P times the
// slot's V scale before P.V, fresh keys (k_new / v_new, bf16) unscaled.
//
// A sibling of tile::attend (attn_tile.cuh), with the same block (4 warps,
// 64 flat query rows f = i*G + g), 64-slot KV tiles, tile skipping by
// positions, ldmatrix / mma.sync m16n8k16 loop and online softmax; kept
// apart so that K1's and bf16 K4's code is not touched. What differs:
//
//   * Copies: a cache tile's 64 K and 64 V rows are copied as int8 (D
//     bytes a row, padded by 16) by cp.async 16-byte copies, with their 64
//     K and 64 V fp32 scales (4-byte copies), double-buffered: half the
//     bytes of a bf16 tile. Each landed tile is widened into one bf16 K/V
//     tile in shared memory, exactly (|x| <= 127 fits bf16's 8-bit
//     significand), which the mma loop reads as attend reads its tiles.
//     A fresh tile is copied as bf16 rows into the int8 stages' bytes
//     (they hold one bf16 K/V tile), issued once the tile before it has
//     been widened, and moved into the bf16 tile with scales 1. The bf16
//     tile is single: per tile, find the next live tile, wait for this
//     tile's copy and the previous tile's products (one barrier), issue
//     the next cache tile's copy, widen, barrier, products; the next copy
//     is in flight through both.
//   * Scores: S = Q.K^T, exact products of bf16 queries and int8-valued
//     keys, fp32 accumulation; each column times its slot's K scale, as
//     the reference does (`s * ks`), before the mask and the softmax.
//   * P.V without a bf16 rounding of P x v_scale: P' = p * v_scale (fp32)
//     is split into hi = bf16_rn(P') and lo = bf16_rn(P' - hi), and hi.V
//     and lo.V accumulate into the same fp32 fragment (two mma.sync per
//     k-step, one V fragment). |P' - hi| <= 2^-8 |P'| and |P' - hi - lo|
//     <= 2^-8 |P' - hi|, so P' is carried to 2^-16 relative where one
//     bf16 rounding errs by 2^-8; V is exact (int8 values, or bf16 v_new).
//     The fresh keys take the same split, so they are within 2^-16 of the
//     Pallas finalize's fp32. The row sum uses the unrounded p.
//
// What bounds it on the H100: bytes, as paged_mma (a chunk's 128 queries
// read their row's KV twice, once per 64-row tile, at about a byte per
// element plus 8 bytes of scales per slot). The widening adds shared
// memory traffic (an int8 tile read, a bf16 tile written) beside the
// loop's ldmatrix reads, and the split adds one mma per P.V product.
#pragma once

#include "attn_tile.cuh"

namespace llmss {
namespace tile {

// Shared memory: Q [kRows][LD] | widened K, V [kSlots][LD] (bf16) | int8
// stages [2][K, V][kSlots][LD8] (or one fresh bf16 K, V tile [2][kSlots]
// [LD] in their bytes) | scales [2][K, V][kSlots] fp32 | positions
// [2][kSlots]. Mirrored by ops/_build.py::tile_i8_smem_bytes.
template <int D> struct SmemI8 {
  static constexpr int LD = D + 8;    // bf16 row: 16 bytes of padding
  static constexpr int LD8 = D + 16;  // int8 row: 16 bytes of padding
  static constexpr int Q = kRows * LD;
  static constexpr int KV = kSlots * LD;
  static constexpr int KV8 = kSlots * LD8;
  static_assert(4 * KV8 >= 2 * KV * 2, "a fresh bf16 K/V tile fits the int8 stages");
  static constexpr size_t bytes = 2 * (size_t(Q) + 2 * size_t(KV)) + 4 * size_t(KV8) +
                                  4 * 2 * 2 * kSlots + 2 * kSlots * sizeof(int);
};

// 4 bytes global -> shared; valid false fills the destination with zeros.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// Sixteen int8 values widened to bf16 (exact), lowest address first,
// with integer and fp32 adds instead of conversions: byte x ^ 0x80 (x +
// 128) as the low byte of the fp32 2^23 + x + 128, minus 2^23 + 128, is x;
// |x| <= 128 has at most 8 significant bits, so its bf16 is the upper half
// of its fp32.
__device__ __forceinline__ void widen16(const uint4& in, uint4 out[2]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&in);
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
    uint32_t f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      f[b] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + b)) -
                             8388736.f);
    o[2 * i] = __byte_perm(f[0], f[1], 0x7632);
    o[2 * i + 1] = __byte_perm(f[2], f[3], 0x7632);
  }
}

// hi = bf16_rn(x), lo = bf16_rn(x - hi) of two values, each pair packed
// as an A-fragment word (a in the low half).
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = pack2<__nv_bfloat16>(a - hf.x, b - hf.y);
}

// Source interface: attend's (its rows() is called for fresh tiles only),
// and
//   int n_cache             tiles [0, n_cache) are the pool's, the rest
//                           fresh
//   const float *ks, *vs    the pool's K and V scales
//   bool rows8(int t, int j, const int8_t*& k, const int8_t*& v,
//              long long& so)   the int8 K/V rows of slot j of cache tile
//                           t and the offset of its scales; false past the
//                           end (zero-filled, scales 0)
template <int D, class Src>
__device__ __forceinline__ void attend_i8(const Src& src, unsigned char* smem) {
  using T = __nv_bfloat16;
  using SM = SmemI8<D>;
  constexpr int LD = SM::LD, LD8 = SM::LD8;
  constexpr int CPR = D / 8;    // 16-byte chunks per bf16 row
  constexpr int CPR8 = D / 16;  // 16-byte chunks per int8 row
  static_assert(kThreads == 2 * kSlots, "one thread per K or V scale of a tile");
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + SM::Q;
  T* sV = sK + SM::KV;  // sK's rows continue into sV's: [2 * kSlots][LD]
  int8_t* s8 = reinterpret_cast<int8_t*>(sV + SM::KV);
  T* sF = reinterpret_cast<T*>(s8);  // a fresh tile: K then V, as sK, sV
  float* sS = reinterpret_cast<float*>(s8 + 4 * SM::KV8);
  int* sPos = reinterpret_cast<int*>(sS + 4 * kSlots);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = src.n_tiles;

  for (int c = tid; c < kRows * CPR; c += kThreads) {
    const int r = c / CPR, part = c % CPR;
    const T* g = src.q_row(r);
    cp_async16(sQ + r * LD + part * 8, g ? g + part * 8 : src.any_ptr(), g != nullptr);
  }

  auto live = [&](int p) {
    return p >= 0 && p <= src.qmax && (src.window <= 0 || p > src.qmin - src.window);
  };
  // As attend's: the first tile at or after t some row of the block sees.
  auto next_live = [&](int t, int& p0, int& p1) {
    for (; t < n_tiles; t += kLook) {
      int a[kLook], b[kLook];
#pragma unroll
      for (int u = 0; u < kLook; ++u) {
        a[u] = t + u < n_tiles ? src.slot_pos(t + u, lane) : -1;
        b[u] = t + u < n_tiles ? src.slot_pos(t + u, lane + 32) : -1;
      }
#pragma unroll
      for (int u = 0; u < kLook; ++u) {
        if (__any_sync(0xffffffffu, live(a[u]) || live(b[u]))) {
          p0 = a[u];
          p1 = b[u];
          return t + u;
        }
      }
    }
    return n_tiles;
  };
  // A cache tile's int8 rows and scales into int8 stage `stage`; a fresh
  // tile's bf16 rows into sF.
  auto issue = [&](int t, int stage) {
    if (t < src.n_cache) {
      int8_t* kv = s8 + stage * 2 * SM::KV8;
      for (int c = tid; c < kSlots * CPR8; c += kThreads) {
        const int j = c / CPR8, part = c % CPR8;
        const int8_t *kr, *vr;
        long long so;
        const bool ok = src.rows8(t, j, kr, vr, so);
        const void* any = src.any_ptr();
        cp_async16(kv + j * LD8 + part * 16, ok ? static_cast<const void*>(kr + part * 16) : any,
                   ok);
        cp_async16(kv + SM::KV8 + j * LD8 + part * 16,
                   ok ? static_cast<const void*>(vr + part * 16) : any, ok);
      }
      const int j = tid % kSlots, is_v = tid / kSlots;
      const int8_t *kr, *vr;
      long long so;
      const bool ok = src.rows8(t, j, kr, vr, so);
      const float* sc = (is_v ? src.vs : src.ks) + so;
      cp_async4(sS + (stage * 2 + is_v) * kSlots + j,
                ok ? static_cast<const void*>(sc) : src.any_ptr(), ok);
    } else {
      for (int c = tid; c < kSlots * CPR; c += kThreads) {
        const int j = c / CPR, part = c % CPR;
        const T *kr, *vr;
        const bool ok = src.rows(t, j, kr, vr);
        cp_async16(sF + j * LD + part * 8, ok ? kr + part * 8 : src.any_ptr(), ok);
        cp_async16(sF + SM::KV + j * LD + part * 8, ok ? vr + part * 8 : src.any_ptr(), ok);
      }
    }
  };
  // Tile t, landed, into the bf16 K/V tile (and, fresh, scales 1).
  auto widen = [&](int t, int stage) {
    if (t < src.n_cache) {
      const int8_t* kv = s8 + stage * 2 * SM::KV8;
      for (int c = tid; c < 2 * kSlots * CPR8; c += kThreads) {
        const int r = c / CPR8, part = c % CPR8;
        uint4 out[2];
        widen16(*reinterpret_cast<const uint4*>(kv + r * LD8 + part * 16), out);
        uint4* dst = reinterpret_cast<uint4*>(sK + r * LD + part * 16);
        dst[0] = out[0];
        dst[1] = out[1];
      }
    } else {
      const uint4* from = reinterpret_cast<const uint4*>(sF);
      uint4* to = reinterpret_cast<uint4*>(sK);
      for (int c = tid; c < 2 * SM::KV / 8; c += kThreads) to[c] = from[c];
      sS[stage * 2 * kSlots + tid] = 1.f;
    }
  };

  const int g4 = lane / 4, t4 = lane % 4;
  const int row0 = warp * 16 + g4;  // this thread's rows: row0, row0 + 8
  const int qp[2] = {src.q_pos(row0), src.q_pos(row0 + 8)};
  const int window = src.window;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  int p0 = -1, p1 = -1;
  int cur = next_live(0, p0, p1);
  if (cur < n_tiles) {
    if (warp == 0) {
      sPos[lane] = p0;
      sPos[lane + 32] = p1;
    }
    issue(cur, 0);
  }
  cp_async_commit();  // Q with the first tile
  int stage = 0;
  while (cur < n_tiles) {
    const int nxt = next_live(cur + 1, p0, p1);  // its loads overlap the wait
    cp_async_wait<0>();  // this tile's copy
    __syncthreads();     // landed for all; the previous products are done
    if (nxt < n_tiles && warp == 0) {
      sPos[(stage ^ 1) * kSlots + lane] = p0;
      sPos[(stage ^ 1) * kSlots + lane + 32] = p1;
    }
    if (nxt < src.n_cache) issue(nxt, stage ^ 1);
    widen(cur, stage);
    __syncthreads();  // the bf16 tile is whole; this int8 stage is free
    // A fresh tile's copy goes into the int8 stages' bytes: after the
    // widening (no cache tile follows a fresh one, so no copy is in flight).
    if (nxt < n_tiles && nxt >= src.n_cache) issue(nxt, stage ^ 1);
    cp_async_commit();

    const float* ksc = sS + stage * 2 * kSlots;
    const float* vsc = ksc + kSlots;
    const int* pos = sPos + stage * kSlots;

    // S = Q K^T: 16 rows x 64 slots per warp, 8 n-tiles of 8 slots.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        uint32_t b[4];
        ldsm_x4(b, sK + (nn * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                       ((lane >> 3) & 1) * 8);
        mma<T>(s[2 * nn], a, b[0], b[1]);
        mma<T>(s[2 * nn + 1], a, b[2], b[3]);
      }
    }

    // K scale, mask, online softmax. Element e of n-tile n: row row0 +
    // 8*(e/2), slot 8n + 2*t4 + e%2.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 ks = *reinterpret_cast<const float2*>(ksc + n * 8 + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = pos[n * 8 + 2 * t4 + (e & 1)];
        const bool vis = sees(p, qp[e >> 1], window);
        s[n][e] = vis ? s[n][e] * (e & 1 ? ks.y : ks.x) * src.scale_log2 : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      alpha[rr] = exp2f(m[rr] - mx[rr]);
      m[rr] = mx[rr];
      l[rr] *= alpha[rr];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[n][e];
        const float p = x == kNegInf ? 0.f : exp2f(x - mx[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += (hi + lo) V: P' = P * v_scale as two bf16 A fragments per
    // 16-slot k-step, each V fragment (ldmatrix.trans) used by both.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float2 v0 = *reinterpret_cast<const float2*>(vsc + kk * 16 + 2 * t4);
      const float2 v1 = *reinterpret_cast<const float2*>(vsc + kk * 16 + 8 + 2 * t4);
      uint32_t hi[4], lo[4];
      split2(s[2 * kk][0] * v0.x, s[2 * kk][1] * v0.y, hi[0], lo[0]);
      split2(s[2 * kk][2] * v0.x, s[2 * kk][3] * v0.y, hi[1], lo[1]);
      split2(s[2 * kk + 1][0] * v1.x, s[2 * kk + 1][1] * v1.y, hi[2], lo[2]);
      split2(s[2 * kk + 1][2] * v1.x, s[2 * kk + 1][3] * v1.y, hi[3], lo[3]);
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t b[4];
        ldsm_x4_trans(b, sV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                             nd * 16 + (lane >> 4) * 8);
        mma<T>(o[2 * nd], hi, b[0], b[1]);
        mma<T>(o[2 * nd], lo, b[0], b[1]);
        mma<T>(o[2 * nd + 1], hi, b[2], b[3]);
        mma<T>(o[2 * nd + 1], lo, b[2], b[3]);
      }
    }
    cur = nxt;
    stage ^= 1;
  }
  cp_async_wait<0>();
  finish<T, D>(src, row0, t4, m, l, o);
}

}  // namespace tile
}  // namespace llmss
