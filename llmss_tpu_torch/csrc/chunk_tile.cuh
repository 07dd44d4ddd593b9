// The chunk tile: K4 at CB > 1 (csrc/paged_attention.cu paged_mma<KV, D,
// false>), bf16 queries over a bf16 pool or an int8 one.
//
// Replaces llmss_tpu/ops/pallas_ragged.py::ragged_paged_attention (:220,
// pallas_call :315) at CB > 1, its int8 branch (`quant`, :80-87, :144,
// :163-168) included. The function is paged_attention.cu's (the causal
// bound q_pos + i, the pending ring range from slot0, fresh keys visible
// when j <= i < q_len, sentinels clamped to block N - 1, the window,
// masked probabilities exactly 0, P rounded to bf16 before P.V; over int8
// each score times its slot's K scale and P x v_scale carried as hi + lo
// bf16 terms, attn_tile_i8.cuh).
//
// What bounds it on the H100: bytes. Each (row, KV head, 64 flat query
// rows f = i*G + g) reads the row's visible slots once, far below the ~295
// flops per byte where the tensor cores would limit. The tile before this
// one (attn_tile.cuh attend, attn_tile_i8.cuh attend_i8) lost to its
// bound in two ways, and the design answers each:
//   * No split: one block walked its row's whole cache, so the batch's
//     longest row set the time (a 1-query decode row 13-16 tiles long
//     beside prefill rows of 2-4). Here the row's read is cut into S
//     splits of `split` slots (grid z = query tile * S + split, planned
//     from host values only, ops/split_plan.py chunk_plan). Split s reads
//     slots [s * split, (s + 1) * split) of the row's occupied ones;
//     splits past them return at once. The fresh chunk's keys ride the
//     row's last live split, so they are folded once per (row, query). A
//     row with one live split is finished by that block; otherwise each
//     live split stores its live query rows' fp32 state (acc, m in log2
//     units, l) in a workspace [B, CB, Hq, S, D + 2] and chunk_merge,
//     launched next on the same stream (a programmatic dependent launch),
//     folds them in split order. The grid launches a row's later splits
//     first (grid z = (S - 1 - split) * tiles + query tile): on the H100
//     neither order won in total, and split order made one case
//     (k4_int8_gqa_wrap_window) slower than the unsplit tile before it
//     (kernel_ab.py, PERF.md).
//   * A chain of dependent loads per tile (every warp read the next
//     tiles' positions from device memory, then a table entry per 16-byte
//     chunk, then issued the copy) behind a two-stage ring. Here a block
//     stages kPosWin slots' visibility (masked to what some live row of
//     the tile can see) and their table entries in shared memory once,
//     with a mask of the 64-slot tiles holding a visible slot; only those
//     tiles are copied, and of them only the visible slots. The split's
//     first tiles below the rows' positions are copied before any
//     position is read. bf16: a cp.async ring of 3 stages at D <= 128 (2
//     at D 256) with Q in registers (D 256: in shared memory), so two
//     copies are in flight while a tile's products run.
//   * int8 (D <= 128; at D 256 paged_attention.cu keeps the 64-row tile,
//     which stayed faster there): tiles land in an int8 ring (2 stages; 3
//     at D 64) and are widened (exactly) into a double-buffered bf16 tile:
//     per tile one barrier, after which tile k + 1 is widened, the copy of
//     tile k + 1 + ST goes into the stage it left, and tile k's products
//     run, so ST copies are in flight and neither they nor the widening
//     wait on the products.
// A warp whose 16 rows are all chunk padding (rows i >= q_len) skips the
// products; padding rows are written as zeros.
//
// Numerics: as attn_tile.cuh (scores scaled by scale * log2 e, exp2f, fp32
// state, P rounded to bf16 before P.V, the fresh keys' too; int8: hi + lo).
// Each split's P is relative to its own running max and the merge folds
// the splits' states in fp32, so the result differs from the unsplit
// order only in rounding.
#pragma once

#include "attn_tile.cuh"
#include "attn_tile_i8.cuh"
#include "common.cuh"
#include "split_merge.cuh"

namespace llmss {
namespace chunk {

constexpr int kRows = tile::kRows;       // flat query rows a block, 16 a warp
constexpr int kSlots = tile::kSlots;     // KV slots a tile
constexpr int kThreads = tile::kThreads; // 4 warps
constexpr int kPosWin = 512;             // slots whose visibility a block stages at once
constexpr int kMaxCols = kPosWin / 8 + 2;  // table columns of a window (bs >= 8)

// Shared memory: the cp.async ring (bf16: K [ST][kSlots][LD] | V; int8: K
// [ST][kSlots][D] bytes | V) | int8: the widened bf16 tiles (K [NB][kSlots]
// [LD] | V) | Q [kRows][LD] at D 256 | int8: scales, K / V [ST + NB]
// [kSlots] fp32 (the ring's stages, then the widened tiles') | visibility
// [kPosWin] | table entries [kMaxCols] | two tile masks. Mirrored by
// ops/_build.py chunk_smem_bytes.
template <typename KV, int D> struct Smem {
  static constexpr bool kI8 = sizeof(KV) == 1;
  static constexpr bool kQSmem = D > 128;
  static constexpr int LD = D + 8;  // bf16 row: 16 bytes of padding
  static constexpr int ST = kI8 ? (D <= 64 ? 3 : 2) : (D > 128 ? 2 : 3);
  static constexpr int NB = kI8 ? 2 : 0;
  static constexpr size_t TILE = size_t(kSlots) * LD * 2;  // one bf16 K or V tile
  static constexpr size_t TILE8 = size_t(kSlots) * D;      // one int8 K or V tile
  static constexpr size_t ring = ST * 2 * (kI8 ? TILE8 : TILE);
  static constexpr size_t bufs = NB * 2 * TILE;
  static constexpr size_t q = kQSmem ? size_t(kRows) * LD * 2 : 0;
  static constexpr size_t scales = kI8 ? size_t(ST + NB) * 2 * kSlots * 4 : 0;
  static constexpr size_t bytes = ring + bufs + q + scales + 4 * (kPosWin + kMaxCols + 2);
};

// One block's work: flat rows f0 .. f0 + 63 of row b under KV head hk,
// against split `split`'s cache slots [t_lo, t_hi) and, if jmax > 0, the
// fresh keys 0 .. jmax - 1.
template <typename KV>
struct Chunk {
  using T = __nv_bfloat16;
  const T *q, *kn, *vn;
  T* o;
  const KV *kp, *vp;         // the pool, at element offset base + ...
  const float *ks, *vs;      // int8: its scales [L, Np, bs, Hkv]
  const int *kvp, *bt;       // row b's positions and table
  int b, hk, G, f0, nrows, CB, Hq, Hkv;
  int qp, ql, sl0, ring, window, bs, last_blk;
  int i_lo, i_hi;            // the tile's first and last live query
  int t_lo, t_hi, jmax;
  bool finish;               // this block writes the output
  long long base, blk_stride, slot_stride;
  float scale_log2;
  float* ws;                 // finish false: the workspace
  long long n_part;          // B * CB * Hq * S
  int S, split;
};

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename KV, int D>
__device__ __forceinline__ void run(const Chunk<KV>& s, unsigned char* smem) {
  using T = __nv_bfloat16;
  using SM = Smem<KV, D>;
  constexpr bool kI8 = SM::kI8;
  constexpr int LD = SM::LD, ST = SM::ST, NB = SM::NB;
  constexpr int CPR = D / 8;    // 16-byte chunks of a bf16 row
  constexpr int CPR8 = D / 16;  // of an int8 row
  constexpr int PPT = kPosWin / kThreads;
  // Items a window issues before its loop: bf16 ST - 1 ring stages; int8
  // the whole ring.
  constexpr int P = kI8 ? ST : ST - 1;
  static_assert(!kI8 || D <= 128, "over int8 at D 256 K4 keeps the 64-row tile");
  static_assert(kThreads == 2 * kSlots, "one thread per K or V scale of a tile");

  unsigned char* at = smem;
  T* rK = reinterpret_cast<T*>(at);  // bf16 ring
  T* rV = rK + ST * kSlots * LD;
  int8_t* rK8 = reinterpret_cast<int8_t*>(at);  // int8 ring
  int8_t* rV8 = rK8 + ST * kSlots * D;
  at += SM::ring;
  T* bK = reinterpret_cast<T*>(at);  // int8: widened tiles
  T* bV = bK + NB * kSlots * LD;
  at += SM::bufs;
  T* sQ = reinterpret_cast<T*>(at);
  at += SM::q;
  float* sSc = reinterpret_cast<float*>(at);  // [ST][2][kSlots] | [NB][2][kSlots]
  float* sScB = sSc + ST * 2 * kSlots;
  at += SM::scales;
  int* sPos = reinterpret_cast<int*>(at);
  int* sBlk = sPos + kPosWin;
  unsigned* sMask = reinterpret_cast<unsigned*>(sBlk + kMaxCols);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g4 = lane / 4, t4 = lane % 4;
  // A narrow tile (at most 16 live flat rows: decode rows, short chunks)
  // gives each warp the same 16 rows and a quarter of every tile's slots;
  // otherwise warp w takes rows 16w .. 16w + 15 and all 64 slots. Not at
  // D 256, where a second form of the products spilled (112 bytes).
  const bool narrow = D <= 128 && s.ql * s.G - s.f0 <= 16;
  const int row0 = (narrow ? 0 : warp * 16) + g4;  // this thread's rows: row0, row0 + 8
  const int window = s.window;
  const float scale_log2 = s.scale_log2;

  // Flat row r's query (null for padding and rows past the chunk) and
  // position (-1 then: it sees nothing and ends as zeros).
  auto q_row = [&](int r) -> const T* {
    const int f = s.f0 + r;
    if (f >= s.nrows || f / s.G >= s.ql) return nullptr;
    return s.q + ((long long)(s.b * s.CB + f / s.G) * s.Hq + s.hk * s.G + f % s.G) * D;
  };
  const int qrow[2] = {q_row(row0) ? s.qp + (s.f0 + row0) / s.G : -1,
                       q_row(row0 + 8) ? s.qp + (s.f0 + row0 + 8) / s.G : -1};
  const bool warp_live = __any_sync(0xffffffffu, qrow[0] >= 0 || qrow[1] >= 0);
  const int qmax = s.qp + s.i_hi, qmin = s.qp + s.i_lo;

  uint32_t qa[SM::kQSmem ? 1 : D / 16][4];
  if constexpr (SM::kQSmem) {
    for (int c = tid; c < kRows * CPR; c += kThreads) {
      const int r = c / CPR, part = c % CPR;
      const T* g = q_row(r);
      tile::cp_async16(sQ + r * LD + part * 8, g ? g + part * 8 : s.kn, g != nullptr);
    }  // in the first commit group
  } else {
    const T* r0 = q_row(row0);
    const T* r1 = q_row(row0 + 8);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t4;
      qa[kk][0] = r0 ? ld_u32(r0 + c) : 0u;
      qa[kk][1] = r1 ? ld_u32(r1 + c) : 0u;
      qa[kk][2] = r0 ? ld_u32(r0 + c + 8) : 0u;
      qa[kk][3] = r1 ? ld_u32(r1 + c + 8) : 0u;
    }
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  auto slot_off = [&](int x, int blk) {
    return s.base + blk * s.blk_stride + (long long)(x % s.bs) * s.slot_stride;
  };
  // Cache tile of slots x0 .. x0 + 63 into ring stage st: slots past the
  // split, and (staged, window from w0) hidden ones, zero-filled; the
  // table entry from the staged ones, or (ahead of the staging) read here.
  auto issue_cache = [&](int st, int x0, int w0, bool staged) {
    auto blk_of = [&](int x) {
      return staged ? sBlk[x / s.bs - w0 / s.bs] : min(__ldg(s.bt + x / s.bs), s.last_blk);
    };
    if constexpr (!kI8) {
      T* kd = rK + st * kSlots * LD;
      T* vd = rV + st * kSlots * LD;
      for (int c = tid; c < kSlots * CPR; c += kThreads) {
        const int j = c / CPR, part = c % CPR, x = x0 + j;
        const bool ok = x < s.t_hi && (!staged || sPos[x - w0] >= 0);
        const long long off = ok ? slot_off(x, blk_of(x)) + part * 8 : 0;
        tile::cp_async16(kd + j * LD + part * 8, s.kp + off, ok);
        tile::cp_async16(vd + j * LD + part * 8, s.vp + off, ok);
      }
    } else {
      int8_t* kd = rK8 + st * kSlots * D;
      int8_t* vd = rV8 + st * kSlots * D;
      for (int c = tid; c < kSlots * CPR8; c += kThreads) {
        const int j = c / CPR8, part = c % CPR8, x = x0 + j;
        const bool ok = x < s.t_hi && (!staged || sPos[x - w0] >= 0);
        const long long off = ok ? slot_off(x, blk_of(x)) + part * 16 : 0;
        tile::cp_async16(kd + j * D + part * 16, s.kp + off, ok);
        tile::cp_async16(vd + j * D + part * 16, s.vp + off, ok);
      }
      const int j = tid % kSlots, is_v = tid / kSlots, x = x0 + j;
      const bool ok = x < s.t_hi && (!staged || sPos[x - w0] >= 0);
      const long long so = ok ? slot_off(x, blk_of(x)) / D : 0;
      tile::cp_async4(sSc + (st * 2 + is_v) * kSlots + j, (is_v ? s.vs : s.ks) + so, ok);
    }
  };
  // Fresh tile jt (keys jt * 64 + j < jmax, bf16) into K / V tiles kd, vd.
  auto issue_fresh = [&](T* kd, T* vd, int jt) {
    for (int c = tid; c < kSlots * CPR; c += kThreads) {
      const int j = c / CPR, part = c % CPR, jj = jt * kSlots + j;
      const bool ok = jj < s.jmax;
      const long long off =
          ok ? ((long long)(s.b * s.CB + jj) * s.Hkv + s.hk) * D + part * 8 : 0;
      tile::cp_async16(kd + j * LD + part * 8, s.kn + off, ok);
      tile::cp_async16(vd + j * LD + part * 8, s.vn + off, ok);
    }
  };
  // int8: ring stage st, landed, widened into bf16 tile bi with its scales.
  auto widen = [&](int st, int bi) {
    for (int c = tid; c < 2 * kSlots * CPR8; c += kThreads) {
      const int kv = c / (kSlots * CPR8), r = c / CPR8 % kSlots, part = c % CPR8;
      const int8_t* from = (kv ? rV8 : rK8) + (st * kSlots + r) * D + part * 16;
      uint4 out[2];
      tile::widen16(*reinterpret_cast<const uint4*>(from), out);
      uint4* to = reinterpret_cast<uint4*>((kv ? bV : bK) + (bi * kSlots + r) * LD + part * 16);
      to[0] = out[0];
      to[1] = out[1];
    }
    sScB[bi * 2 * kSlots + tid] = sSc[st * 2 * kSlots + tid];
  };

  // Fold one tile (K / V rows k, v; int8: K / V scales ksc, vsc) into this
  // warp's rows. Slot j's position: pw[j] for a cache tile, else fresh key
  // j0 + j's.
  auto products = [&](auto nj, const T* k, const T* v, const int* pw, int j0,
                      const float* ksc, const float* vsc) {
    // This warp's NJ slots of the tile, from js.
    constexpr int NJ = decltype(nj)::value;
    const int js = NJ == kSlots ? 0 : warp * NJ;
    auto pos = [&](int j) {
      return pw ? pw[j] : j0 + j < s.jmax ? s.qp + j0 + j : -1;
    };
    float sc[NJ / 8][4];
#pragma unroll
    for (int n = 0; n < NJ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      if constexpr (SM::kQSmem) {
        tile::ldsm_x4(a, sQ + (row0 - g4 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qa[kk][e];
      }
#pragma unroll
      for (int nn = 0; nn < NJ / 16; ++nn) {
        uint32_t b[4];
        tile::ldsm_x4(b, k + (js + nn * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                             ((lane >> 3) & 1) * 8);
        tile::mma<T>(sc[2 * nn], a, b[0], b[1]);
        tile::mma<T>(sc[2 * nn + 1], a, b[2], b[3]);
      }
    }
    // Element e of n-tile n: row row0 + 8 * (e / 2), slot js + 8n + 2 t4 + e % 2.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NJ / 8; ++n) {
      float2 ks = make_float2(1.f, 1.f);
      if constexpr (kI8) ks = *reinterpret_cast<const float2*>(ksc + js + n * 8 + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool vis = tile::sees(pos(js + n * 8 + 2 * t4 + (e & 1)), qrow[e >> 1], window);
        if constexpr (kI8) {
          sc[n][e] = vis ? sc[n][e] * (e & 1 ? ks.y : ks.x) * scale_log2 : kNegInf;
        } else {
          sc[n][e] = vis ? sc[n][e] * scale_log2 : kNegInf;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
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
    for (int n = 0; n < NJ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = sc[n][e];
        const float p = x == kNegInf ? 0.f : exp2f(x - mx[e >> 1]);
        sc[n][e] = p;
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
    // O += P V: P (16 x NJ) as 16-slot A fragments (int8: P x v_scale as
    // hi + lo), V by ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < NJ / 16; ++kk) {
      uint32_t hi[4], lo[4];
      if constexpr (kI8) {
        const float2 v0 = *reinterpret_cast<const float2*>(vsc + js + kk * 16 + 2 * t4);
        const float2 v1 = *reinterpret_cast<const float2*>(vsc + js + kk * 16 + 8 + 2 * t4);
        tile::split2(sc[2 * kk][0] * v0.x, sc[2 * kk][1] * v0.y, hi[0], lo[0]);
        tile::split2(sc[2 * kk][2] * v0.x, sc[2 * kk][3] * v0.y, hi[1], lo[1]);
        tile::split2(sc[2 * kk + 1][0] * v1.x, sc[2 * kk + 1][1] * v1.y, hi[2], lo[2]);
        tile::split2(sc[2 * kk + 1][2] * v1.x, sc[2 * kk + 1][3] * v1.y, hi[3], lo[3]);
      } else {
        hi[0] = tile::pack2<T>(sc[2 * kk][0], sc[2 * kk][1]);
        hi[1] = tile::pack2<T>(sc[2 * kk][2], sc[2 * kk][3]);
        hi[2] = tile::pack2<T>(sc[2 * kk + 1][0], sc[2 * kk + 1][1]);
        hi[3] = tile::pack2<T>(sc[2 * kk + 1][2], sc[2 * kk + 1][3]);
      }
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t b[4];
        tile::ldsm_x4_trans(b, v + (js + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                   nd * 16 + (lane >> 4) * 8);
        tile::mma<T>(o[2 * nd], hi, b[0], b[1]);
        tile::mma<T>(o[2 * nd + 1], hi, b[2], b[3]);
        if constexpr (kI8) {
          tile::mma<T>(o[2 * nd], lo, b[0], b[1]);
          tile::mma<T>(o[2 * nd + 1], lo, b[2], b[3]);
        }
      }
    }
  };

  // The split's first tiles of the rows' visible range (positions from
  // the earliest row's window to the latest row's position; below a
  // ring's wrap logical slot t holds position t), tiles a0 .. a0 + nf - 1
  // of its first window, are copied before any position is read.
  // The first window's positions and table entries, loaded first: the
  // ahead copies' table reads then overlap them.
  int pv[PPT];
  const int w1_0 = min(s.t_hi, s.t_lo + kPosWin);
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int t = s.t_lo + j * kThreads + tid;
    pv[j] = t < w1_0 ? __ldg(s.kvp + t) : -1;
  }
  int bv = s.t_lo / s.bs + tid <= (w1_0 - 1) / s.bs && w1_0 > s.t_lo
               ? __ldg(s.bt + s.t_lo / s.bs + tid) : 0;
  const int vlo = window > 0 ? max(0, qmin - window + 1) : 0;
  const int a0 = max(0, vlo - s.t_lo) / kSlots;
  const int a1 = (min(min(s.t_hi, qmax + 1), s.t_lo + kPosWin) - s.t_lo + kSlots - 1) / kSlots;
  const int nf = a1 > a0 ? min(P, a1 - a0) : 0;
  for (int k = 0; k < nf; ++k) {
    issue_cache(k % ST, s.t_lo + (a0 + k) * kSlots, s.t_lo, false);
    tile::cp_async_commit();
  }
  if (tid == 0) sMask[0] = sMask[1] = 0u;
  const int n_fresh = (s.jmax + kSlots - 1) / kSlots;

  bool first = true;
  for (int w0 = s.t_lo, wi = 0; first || w0 < s.t_hi; w0 += kPosWin, wi ^= 1) {
    const int w1 = min(s.t_hi, w0 + kPosWin);
    const bool last = w0 + kPosWin >= s.t_hi;  // the fresh tiles follow this window's
    const int c0 = w0 / s.bs;
    const int ncol = w1 > w0 ? (w1 - 1) / s.bs - c0 + 1 : 0;
    if (!first) {
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const int t = w0 + j * kThreads + tid;
        pv[j] = t < w1 ? __ldg(s.kvp + t) : -1;
      }
      bv = tid < ncol ? __ldg(s.bt + c0 + tid) : 0;
    }
    // The previous window's tiles and mask are consumed; this window's
    // mask is clear (zeroed before the loop, or after the mask before).
    __syncthreads();
    if (tid == 0) sMask[wi ^ 1] = 0u;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int i = j * kThreads + tid, t = w0 + i, p = pv[j];
      int d = t - s.sl0;
      if (d < 0) d += s.ring;
      // Some live row of the tile may see it, and it is not pending.
      const bool vis = t < w1 && d >= s.ql && p >= 0 && p <= qmax &&
                       (window <= 0 || p > qmin - window);
      sPos[i] = vis ? p : -1;
      if (__any_sync(0xffffffffu, vis) && lane == 0) atomicOr(sMask + wi, 1u << (i / kSlots));
    }
    if (tid < ncol) sBlk[tid] = min(bv, s.last_blk);
    __syncthreads();

    // This window's items: the n0 tiles copied ahead (first window only),
    // the later tiles some slot of which is visible, then (last window)
    // the fresh tiles.
    const int n0 = first ? nf : 0;
    const unsigned mask = sMask[wi] & ~(((1u << n0) - 1u) << a0);
    const int n_cache = n0 + __popc(mask);
    const int n_items = n_cache + (last ? n_fresh : 0);
    auto tile_at = [&](int k) {  // window slot of cache item k
      if (k < n0) return (a0 + k) * kSlots;
      unsigned rest = mask;
      for (int i = n0; i < k; ++i) rest &= rest - 1;
      return (__ffs(rest) - 1) * kSlots;
    };
    // Item k into ring stage st: a cache tile, or (bf16) a fresh one; an
    // int8 block copies its fresh tiles in prep.
    auto issue = [&](int k, int st) {
      if (k < n_cache) {
        issue_cache(st, w0 + tile_at(k), w0, true);
      } else if constexpr (!kI8) {
        if (k < n_items) issue_fresh(rK + st * kSlots * LD, rV + st * kSlots * LD, k - n_cache);
      }
    };
    auto fold = [&](int k, const T* kt, const T* vt, const float* ksc, const float* vsc) {
      if (!warp_live) return;
      const bool cache = k < n_cache;
      const int* pw = cache ? sPos + tile_at(k) : nullptr;
      const int jf = cache ? 0 : (k - n_cache) * kSlots;
      if constexpr (D <= 128) {
        if (narrow) {
          products(std::integral_constant<int, kSlots / 4>{}, kt, vt, pw, jf, ksc, vsc);
          return;
        }
      }
      products(std::integral_constant<int, kSlots>{}, kt, vt, pw, jf, ksc, vsc);
    };

    for (int k = n0; k < P; ++k) {
      if (k < n_items) issue(k, k % ST);
      tile::cp_async_commit();
    }
    if constexpr (!kI8) {
      for (int k = 0; k < n_items; ++k) {
        tile::cp_async_wait<ST - 2>();  // item k landed (this thread's copies)
        __syncthreads();  // ... every thread's; item k - 1's stage is free
        issue(k + ST - 1, (k + ST - 1) % ST);
        tile::cp_async_commit();
        const int st = k % ST;
        fold(k, rK + st * kSlots * LD, rV + st * kSlots * LD, nullptr, nullptr);
      }
    } else {
      // Item k's bf16 tile and scales into tile bi: widened from its ring
      // stage, or a fresh tile copied in (scales 1).
      auto prep = [&](int k, int bi) {
        if (k >= n_items) return;
        if (k < n_cache) {
          widen(k % ST, bi);
        } else {
          issue_fresh(bK + bi * kSlots * LD, bV + bi * kSlots * LD, k - n_cache);
          sScB[bi * 2 * kSlots + tid] = 1.f;
        }
      };
      auto fold_buf = [&](int k, int bi) {
        fold(k, bK + bi * kSlots * LD, bV + bi * kSlots * LD, sScB + bi * 2 * kSlots,
             sScB + bi * 2 * kSlots + kSlots);
      };
      // Item i's copy is commit group i, in ring stage i % ST. A thread
      // widens exactly the int8 chunks (and scale) it copies, so the
      // stage it has just widened takes the copy of item i + ST at once:
      // ST copies are in flight while a tile's products run.
      tile::cp_async_wait<ST - 1>();  // item 0 landed
      __syncthreads();
      prep(0, 0);
      issue(ST, 0);
      tile::cp_async_commit();
      for (int k = 0; k < n_items; ++k) {
        // Item k + 1's copy landed (later ones may be in flight), or item
        // k's fresh copy.
        if (k >= n_cache) {
          tile::cp_async_wait<0>();
        } else {
          tile::cp_async_wait<ST - 1>();
        }
        // Every thread's copies landed and item k's tile is whole; item
        // k - 1's products are done, so its tile is free.
        __syncthreads();
        prep(k + 1, (k + 1) % 2);
        issue(k + 1 + ST, (k + 1) % ST);  // the stage item k + 1 left
        tile::cp_async_commit();
        fold_buf(k, k % 2);
      }
    }
    first = false;
  }
  tile::cp_async_wait<0>();

  // The block's end through shared memory (the ring's bytes, free now):
  // each warp's state of its rows, [64][D + 4] fp32 with m and l; a narrow
  // tile's four warps' states of rows 0 .. 15 are folded in warp order.
  // Then whole rows leave in consecutive 8- (bf16) or 16-byte (fp32)
  // stores: the output (padding rows as zeros), or the live rows' partial
  // states for chunk_merge.
  constexpr int LDA = D + 4;
  float* sAcc = reinterpret_cast<float*>(smem);  // [kRows][LDA]
  float* sM = sAcc + kRows * LDA;                // [kRows]
  float* sL = sM + kRows;
  static_assert(size_t(kRows) * (LDA + 2) * 4 <= SM::ring + SM::bufs, "the end fits the ring");
  __syncthreads();  // every warp is done with the ring
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float sum = l[rr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int at = (narrow ? warp * 16 : 0) + row0 + 8 * rr;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(sAcc + at * LDA + n * 8 + 2 * t4) =
          make_float2(o[n][2 * rr], o[n][2 * rr + 1]);
    if (t4 == 0) {
      sM[at] = m[rr];
      sL[at] = sum;
    }
  }
  __syncthreads();
  constexpr int CW = D / 4;          // threads across a row, 4 elements each
  constexpr int RP = kThreads / CW;  // rows a pass
  const int d = tid % CW * 4;
  for (int r = tid / CW; r < kRows; r += RP) {
    const int f = s.f0 + r;
    if (f >= s.nrows) break;
    const int i = f / s.G;
    const long long row = (long long)(s.b * s.CB + i) * s.Hq + s.hk * s.G + f % s.G;
    if (i >= s.ql || (narrow && r >= 16)) {
      // Padding rows are zeros, from the block that finishes the tile or,
      // on a split tile, from split 0's; the merge writes the live rows.
      if (s.finish || s.split == 0)
        *reinterpret_cast<uint2*>(s.o + row * D + d) = make_uint2(0u, 0u);
      continue;
    }
    float4 x;
    float M, L;
    if (narrow) {
      M = fmaxf(fmaxf(sM[r], sM[16 + r]), fmaxf(sM[32 + r], sM[48 + r]));
      x = make_float4(0.f, 0.f, 0.f, 0.f);
      L = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float mw = sM[w * 16 + r];
        const float sc = mw == kNegInf ? 0.f : exp2f(mw - M);
        const float4 y = *reinterpret_cast<const float4*>(sAcc + (w * 16 + r) * LDA + d);
        L += sL[w * 16 + r] * sc;
        x.x += y.x * sc;
        x.y += y.y * sc;
        x.z += y.z * sc;
        x.w += y.w * sc;
      }
    } else {
      x = *reinterpret_cast<const float4*>(sAcc + r * LDA + d);
      M = sM[r];
      L = sL[r];
    }
    if (s.finish) {
      const float inv = L == 0.f ? 0.f : 1.f / L;  // a row that saw nothing: zeros
      uint2 w;
      w.x = tile::pack2<T>(x.x * inv, x.y * inv);
      w.y = tile::pack2<T>(x.z * inv, x.w * inv);
      *reinterpret_cast<uint2*>(s.o + row * D + d) = w;
    } else {
      const long long st = row * s.S + s.split;
      *reinterpret_cast<float4*>(s.ws + st * D + d) = x;
      if (d == 0) {
        s.ws[s.n_part * D + st] = M;
        s.ws[s.n_part * D + s.n_part + st] = L;
      }
    }
  }
}

struct MergeArgs {
  void* o;          // [B, CB, Hq, D] bf16
  const float* ws;  // acc [B*CB*Hq*S, D], then m, then l [B*CB*Hq*S]
  const int* qlen;  // [B]
  const int* nblk;  // [B]
  int B, CB, Hq, Hkv, S, split, bs, n_cols;
};

// The row's splits that hold occupied slots (at least 1: split 0 carries
// the fresh keys of a row with none).
__device__ __forceinline__ int live_splits(int nblk, int n_cols, int bs, int split) {
  const int t_end = min(max(nblk, 0), n_cols) * bs;
  return t_end > 0 ? (t_end + split - 1) / split : 1;
}

// chunk_merge's threads a block: kThreads for each quarter of a chunk
// tile's flat query rows.
constexpr int kMergeRows = kRows / 4;
constexpr int kMergeThreads = 4 * kThreads;

// One block per (row b, KV head, chunk tile), kThreads a quarter of its 64
// flat query rows: every live query row (i < q_len) of a row with two or
// more live splits folds its live splits' states in split order (m in log2
// units), each split's state loaded at once, and writes the output.
// Padding rows are the chunk kernel's (split 0 writes their zeros), as are
// rows with one live split.
template <int D>
__global__ void __launch_bounds__(kMergeThreads) chunk_merge(MergeArgs a) {
  using T = __nv_bfloat16;
  const int b = blockIdx.x, hk = blockIdx.y;
  const int G = a.Hq / a.Hkv;
  const int f0 = blockIdx.z * kRows + threadIdx.x / kThreads * kMergeRows;
  const int ql = a.qlen[b];
  const int live = live_splits(a.nblk[b], a.n_cols, a.bs, a.split);
  const int n = min(kMergeRows, min(a.CB, ql) * G - f0);  // live flat rows from f0
  // Every block waits for the chunk kernel, so the stream's next grid
  // never overtakes it.
  pdl_wait();
  if (n <= 0 || live < 2) return;  // warp-uniform: a quarter is whole warps
  const long long n_part = (long long)a.B * a.CB * a.Hq * a.S;
  const float* mv = a.ws + n_part * D;
  const float* lv = mv + n_part;
  T* o = static_cast<T*>(a.o);
  for (int c = threadIdx.x % kThreads; c < n * (D / 4); c += kThreads) {
    const int f = f0 + c / (D / 4), d = c % (D / 4) * 4;
    const long long row = (long long)(b * a.CB + f / G) * a.Hq + hk * G + f % G;
    const long long r0 = row * a.S;
    float ms[kMaxSplits], ls[kMaxSplits];
    float4 ys[kMaxSplits];
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {
      if (sp < live) {
        ms[sp] = mv[r0 + sp];
        ls[sp] = lv[r0 + sp];
        ys[sp] = *reinterpret_cast<const float4*>(a.ws + (r0 + sp) * D + d);
      }
    }
    float M = kNegInf;
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < live) M = fmaxf(M, ms[sp]);
    float den = 0.f, O[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp) {  // in split order
      if (sp < live) {
        const float sc = ms[sp] == kNegInf ? 0.f : exp2f(ms[sp] - M);
        den += ls[sp] * sc;
        O[0] += ys[sp].x * sc;
        O[1] += ys[sp].y * sc;
        O[2] += ys[sp].z * sc;
        O[3] += ys[sp].w * sc;
      }
    }
    const float inv = 1.f / den;  // a live row sees its own fresh key: den > 0
    uint2 w;
    w.x = tile::pack2<T>(O[0] * inv, O[1] * inv);
    w.y = tile::pack2<T>(O[2] * inv, O[3] * inv);
    *reinterpret_cast<uint2*>(o + row * D + d) = w;
  }
}

}  // namespace chunk
}  // namespace llmss
