// The group tile: the tensor-core decode tile whose rows follow the query
// heads of one KV head, shared by K2w (window_attention.cu window_mma,
// G * Sw window rows), K2 (decode_attention.cu decode_group, G rows) and
// K3 / K4 at CB = 1 (paged_attention.cu paged_group, G rows). What the
// three differ in (where a slot's K/V rows are, which slots a row sees,
// how many fresh keys a row folds) is a Source's; the loop, the ring and
// the fold are this header's, once.
//
// What bounds it on the H100: memory. A block reads each KV head's slots
// once for its rows, ~4 flops per element and row, far below the ~295
// flops per byte where the tensor cores would become the limit. At the
// decode shapes (a few MB a call) a block's fixed chain of latencies (its
// positions, its first tile, its fold) sets the time as much as its bytes,
// so the design keeps that chain short:
//   * rows per block follow the group: 16 a row warp (one m16n8k16 A
//     fragment), at most 4 row warps (64 rows; more take more blocks), so
//     Qwen2-7B's 7 heads fill 7 of 16 mma rows where the 64-row tile of
//     attn_tile.cuh filled 7 of 64, and slot-parallel warps (4 at one row
//     warp, else 2) split each 64-slot tile's slots;
//   * Q stays in registers (D <= 128; at D 256 the block keeps it in
//     shared memory and reads the fragments by ldmatrix), which leaves room
//     for a three-stage cp.async ring at two blocks an SM;
//   * the first tiles below the rows' position are copied before any
//     position is read;
//   * the splits of a read store their states in split_merge.cuh's
//     workspace and a merge kernel follows (K2's and K3's plans); or they
//     are one thread block cluster that folds them, and the fresh keys, in
//     the kernel, with no second launch and no workspace (K2w's plan up to
//     4 splits; K2 and K3 always merge: on the H100 the merge beat a
//     cluster fold of their splits, ops/split_plan.py).
//
// A block attends R = 16 * RW flat rows against one split's slots
// [t_lo, t_hi), on mma.sync m16n8k16 (bf16 in, fp32 accumulate). Warp w
// owns rows (w % RW) * 16 .. + 15, one A fragment, and the slots j0 .. j0
// + NJ - 1 (j0 = (w / RW) * NJ, NJ = 64 / SW) of every 64-slot tile: its
// SW slot-parallel warps each keep their own fp32 (m, l, acc) of those
// rows.
//   * Visibility: the block stages kPosWin slots' visibility (position p
//     when the Source's vis(t, p) holds, else -1) in shared memory, with a
//     mask of the 64-slot tiles holding any visible slot. Only those tiles
//     are copied, and of them only the visible slots (the rest are
//     zero-filled by the copy's src-size, and masked), but for the first
//     kStages - 1 tiles of the Source's `ahead` slots, which are copied
//     whole before the positions arrive. The mask is the same for every
//     row of the block (a Source's vis does not depend on the row).
//   * Ring: kStages stages of K and V tiles (rows padded by 16 bytes),
//     cp.async.cg 16-byte copies, one __syncthreads a tile; kStages - 1
//     tiles are in flight while one is computed.
//   * Before the KV loop the block also reads what its fold needs: the
//     fresh V rows into shared memory, and the fresh keys' scores of the
//     rows it folds.
//   * Online softmax as attn_tile.cuh's (scores scaled by scale * log2 e,
//     exp2f; masked probabilities exactly 0), P rounded to bf16 in
//     registers before P.V.
//   * End: the SW slot warps' states are folded in shared memory, in slot
//     warp order. kCluster: the S splits of one (row b, KV head, row
//     group) are one thread block cluster (S <= 8, grid z); after a
//     cluster barrier block s folds the rows r = s, s + S, ... (a warp a
//     row): the splits' states read over distributed shared memory, all
//     at once, and folded in split order, then the row's fresh keys j <=
//     last_fresh(r) with scores and V in fp32, and writes the output. A
//     second barrier keeps every block's shared memory alive until the
//     reads are done. kWorkspace: the block stores its state in
//     split_merge.cuh's workspace and a merge kernel follows.
//
// Source interface (all __device__; T = __nv_bfloat16):
//   int nr, t_lo, t_hi, S, split;  live rows, the split's slots, splits
//   int ahead;                     slots from t_lo copied before the
//                                  positions (may be <= 0)
//   const int* kvp;                slot positions, indexed by slot
//   float scale_log2;
//   const T* q_row(int r)          query row of flat row r, nullptr if r >= nr
//   T* o_row(int r)                where its output goes
//   int last_fresh(int r)          its last fresh key (keys 0 .. it)
//   int n_fresh                    fresh V rows the block stages (<= kMaxWin)
//   const T* fresh_k(int j), fresh_v(int j)  fresh key j's K / V row
//   bool vis(int t, int p)         slot t at position p is visible
//   long long kv_off(int t)        element offset of slot t's K / V rows
//   float* ws; long long n_part, row0  the workspace (kWorkspace only)
#pragma once

#include <cooperative_groups.h>

#include "attn_tile.cuh"
#include "common.cuh"
#include "split_merge.cuh"

namespace llmss {
namespace wt {

constexpr int kSlots = 64;     // slots of one K/V tile, one ring stage
// Ring stages: 3 (two blocks an SM at D 128); 2 at D 256, whose 3 would
// not leave room for Q and 64 rows' state.
template <int D> constexpr int kStages = D > 128 ? 2 : 3;
constexpr int kPosWin = 512;   // slots whose visibility a block stages at once
constexpr int kMaxCluster = 8; // the portable cluster size: at most 8 splits
constexpr int kMaxWin = 8;     // fresh K/V rows a block folds (K2w's longest window)

// Slot-parallel warps per row warp.
template <int RW> constexpr int kSlotWarps = RW == 1 ? 4 : 2;

// Shared memory: the ring (K [stages][kSlots][LD] | V [stages][kSlots]
// [LD]), reused after the KV loop by the slot warps' fp32 accumulators
// [SW][R][D + 8] | Q [R][LD] at D 256 | the fresh V [kMaxWin][D] |
// visibility [kPosWin] | two tile masks | m, l [SW][R] | the block's m, l
// [R] | the fresh keys' scores [R][kMaxWin]. Mirrored by ops/_build.py
// window_tile_smem_bytes.
template <int D, int RW> struct Smem {
  static constexpr int SW = kSlotWarps<RW>;
  static constexpr int NW = RW * SW;
  static constexpr int R = 16 * RW;
  static constexpr int LD = D + 8;
  static constexpr bool kQSmem = D > 128;
  static constexpr size_t KV = size_t(kSlots) * LD;
  static constexpr size_t ring = kStages<D> * 2 * KV * sizeof(__nv_bfloat16);
  static constexpr size_t state = size_t(SW) * R * LD * sizeof(float);
  static constexpr size_t region = ring > state ? ring : state;
  static constexpr size_t q = kQSmem ? size_t(R) * LD * sizeof(__nv_bfloat16) : 0;
  static constexpr size_t vn = size_t(kMaxWin) * D * sizeof(__nv_bfloat16);
  static constexpr size_t bytes = region + q + vn + sizeof(int) * (kPosWin + 2) +
                                  sizeof(float) * (2 * SW * R + 2 * R + R * kMaxWin);
};

// How a block's state leaves it.
enum Fold : int { kCluster = 0, kWorkspace = 1 };

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D, int RW, int kFold, class Src>
__device__ __forceinline__ void run(const Src& s, unsigned char* wsmem) {
  using T = __nv_bfloat16;
  using SM = Smem<D, RW>;
  constexpr int SW = SM::SW, NW = SM::NW, NTB = NW * 32, R = SM::R, LD = SM::LD;
  constexpr int NJ = kSlots / SW;  // slots of each tile per warp
  constexpr int CPR = D / 8;       // 16-byte chunks per row
  constexpr int PPT = (kPosWin + NTB - 1) / NTB;
  constexpr int ST = kStages<D>;
  T* sK = reinterpret_cast<T*>(wsmem);
  T* sV = sK + ST * SM::KV;
  float* sAcc = reinterpret_cast<float*>(wsmem);  // [SW][R][LD], after the loop
  T* sQ = reinterpret_cast<T*>(wsmem + SM::region);
  T* sVn = reinterpret_cast<T*>(wsmem + SM::region + SM::q);  // [kMaxWin][D]
  int* sPos = reinterpret_cast<int*>(wsmem + SM::region + SM::q + SM::vn);
  unsigned* sMask = reinterpret_cast<unsigned*>(sPos + kPosWin);  // [2]
  float* sM = reinterpret_cast<float*>(sMask + 2);  // [SW][R]
  float* sL = sM + SW * R;                          // [SW][R]
  float* sMc = sL + SW * R;                         // [R]
  float* sLc = sMc + R;                             // [R]
  float* sSn = sLc + R;                             // [R][kMaxWin]

  if constexpr (kFold == kWorkspace) pdl_trigger();  // the merge may start

  constexpr bool kCl = kFold == kCluster;
  const int nr = s.nr, t_lo = s.t_lo, t_hi = s.t_hi, split = s.split;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rw = warp % RW, j0 = warp / RW * NJ;
  const int g4 = lane / 4, t4 = lane % 4;
  const float scale_log2 = s.scale_log2;

  uint32_t qa[SM::kQSmem ? 1 : D / 16][4];
  if constexpr (SM::kQSmem) {
    for (int c = tid; c < R * CPR; c += NTB) {
      const int r = c / CPR, part = c % CPR;
      const T* g = s.q_row(r);
      *reinterpret_cast<uint4*>(sQ + r * LD + part * 8) =
          g ? *reinterpret_cast<const uint4*>(g + part * 8) : make_uint4(0, 0, 0, 0);
    }  // read after the first window's barriers
  } else {
    const T* r0 = s.q_row(rw * 16 + g4);
    const T* r1 = s.q_row(rw * 16 + g4 + 8);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t4;
      qa[kk][0] = r0 ? ld_u32(r0 + c) : 0u;
      qa[kk][1] = r1 ? ld_u32(r1 + c) : 0u;
      qa[kk][2] = r0 ? ld_u32(r0 + c + 8) : 0u;
      qa[kk][3] = r1 ? ld_u32(r1 + c + 8) : 0u;
    }
  }

  // What the fold at the end needs that the KV loop does not write, read
  // now so that no global load waits there (the merge kernel reads its own
  // in the workspace form): the fresh V rows (a commit group of their own,
  // empty there), and the fresh keys' scores (scale * log2 e units) of the
  // rows this block folds, r = split + S * warp, + S * NW, ... (a warp a
  // row).
  for (int c = tid; kCl && c < s.n_fresh * CPR; c += NTB) {
    const int j = c / CPR, part = c % CPR;
    tile::cp_async16(sVn + j * D + part * 8, s.fresh_v(j) + part * 8, true);
  }
  tile::cp_async_commit();
  if (tid == 0) sMask[0] = sMask[1] = 0u;
  constexpr int E = D / 32;  // features of a lane in the fold
  const int d0 = lane * E;
  for (int r = split + s.S * warp; kCl && r < nr; r += s.S * NW) {
    const int i = s.last_fresh(r);
    const T* qr = s.q_row(r) + d0;
    float qf[E];
#pragma unroll
    for (int e = 0; e < E; ++e) qf[e] = to_f<T>(qr[e]);
#pragma unroll
    for (int j = 0; j < kMaxWin; ++j) {
      if (j > i) break;  // i is the warp's: the shuffles are uniform
      const T* kr = s.fresh_k(j) + d0;
      float x = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) x = fmaf(qf[e], to_f<T>(kr[e]), x);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane == 0) sSn[r * kMaxWin + j] = x * scale_log2;
    }
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  // Fold this warp's slots of the tile in ring stage st (visibility pos,
  // indexed by the tile's slot) into its rows' states.
  auto attend = [&](int st, const int* pos) {
    // A warp whose slots of this tile are all hidden leaves its state as
    // it is (the fold would multiply by 1 and add zeros).
    if (!__any_sync(0xffffffffu, pos[j0 + lane % NJ] >= 0)) return;
    const T* k = sK + st * SM::KV + j0 * LD;
    const T* v = sV + st * SM::KV + j0 * LD;
    float sc[NJ / 8][4];
#pragma unroll
    for (int n = 0; n < NJ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      if constexpr (SM::kQSmem) {
        tile::ldsm_x4(af, sQ + (rw * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) af[e] = qa[kk][e];
      }
#pragma unroll
      for (int nn = 0; nn < NJ / 16; ++nn) {
        uint32_t bf[4];
        tile::ldsm_x4(bf, k + (nn * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                              ((lane >> 3) & 1) * 8);
        tile::mma<T>(sc[2 * nn], af, bf[0], bf[1]);
        tile::mma<T>(sc[2 * nn + 1], af, bf[2], bf[3]);
      }
    }
    // Element e of n-tile n: row g4 + 8 * (e / 2), slot j0 + 8n + 2 t4 + e % 2.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NJ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool vis = pos[j0 + n * 8 + 2 * t4 + (e & 1)] >= 0;
        sc[n][e] = vis ? sc[n][e] * scale_log2 : kNegInf;
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
    // O += P V: P (16 x NJ) as NJ / 16 A fragments, V by ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < NJ / 16; ++kk) {
      const uint32_t af[4] = {
          tile::pack2<T>(sc[2 * kk][0], sc[2 * kk][1]),
          tile::pack2<T>(sc[2 * kk][2], sc[2 * kk][3]),
          tile::pack2<T>(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
          tile::pack2<T>(sc[2 * kk + 1][2], sc[2 * kk + 1][3]),
      };
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t bf[4];
        tile::ldsm_x4_trans(bf, v + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                    nd * 16 + (lane >> 4) * 8);
        tile::mma<T>(o[2 * nd], af, bf[0], bf[1]);
        tile::mma<T>(o[2 * nd + 1], af, bf[2], bf[3]);
      }
    }
  };

  const T* kc = s.kc;
  const T* vc = s.vc;
  // The first window's first ST - 1 tiles of the Source's `ahead` slots
  // (those that start below the rows' positions, which are visible but
  // for the mask's exceptions) are copied before their positions are known
  // (slots past the split zero-filled; hidden ones masked when they are
  // read), so the block's first tile does not wait on the position loads.
  const int ahead = min(s.ahead, t_hi - t_lo);
  const int nf = ahead > 0 ? min(ST - 1, (ahead + kSlots - 1) / kSlots) : 0;
#pragma unroll
  for (int k = 0; k < ST - 1; ++k) {
    if (k < nf) {
      T* kd = sK + k * SM::KV;
      T* vd = sV + k * SM::KV;
      for (int c = tid; c < kSlots * CPR; c += NTB) {
        const int j = c / CPR, part = c % CPR;
        const int t = t_lo + k * kSlots + j;
        const bool ok = t < t_hi;
        const long long off = ok ? s.kv_off(t) + part * 8 : 0;
        tile::cp_async16(kd + j * LD + part * 8, kc + off, ok);
        tile::cp_async16(vd + j * LD + part * 8, vc + off, ok);
      }
    }
    tile::cp_async_commit();
  }

  for (int w0 = t_lo, wi = 0; w0 < t_hi; w0 += kPosWin, wi ^= 1) {
    const int w1 = min(t_hi, w0 + kPosWin);
    int pv[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int t = w0 + j * NTB + tid;
      pv[j] = t < w1 ? __ldg(s.kvp + t) : -1;
    }
    // The previous window's tiles and mask are consumed, this window's
    // mask is clear (zeroed before the loop, or after the mask before).
    __syncthreads();
    if (tid == 0) sMask[wi ^ 1] = 0u;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int i = j * NTB + tid;  // whole warps are past kPosWin together
      if (i < kPosWin) {
        const int p = pv[j];
        const bool vis = s.vis(w0 + i, p);
        sPos[i] = vis ? p : -1;
        if (__any_sync(0xffffffffu, vis) && lane == 0)
          atomicOr(sMask + wi, 1u << (i / kSlots));
      }
    }
    __syncthreads();
    // The tiles of this window: the n0 copied ahead (first window only),
    // then the later ones some slot of which is visible.
    const int n0 = w0 == t_lo ? nf : 0;
    const unsigned mask = sMask[wi] & ~((1u << n0) - 1u);
    const int nl = n0 + __popc(mask);
    auto tile_at = [&](int k) {  // slot of the window's k-th tile
      if (k < n0) return k * kSlots;
      unsigned rest = mask;
      for (int i = n0; i < k; ++i) rest &= rest - 1;
      return (__ffs(rest) - 1) * kSlots;
    };
    auto issue = [&](int k) {
      if (k < nl) {
        const int x0 = tile_at(k);
        T* kd = sK + (k % ST) * SM::KV;
        T* vd = sV + (k % ST) * SM::KV;
        for (int c = tid; c < kSlots * CPR; c += NTB) {
          const int j = c / CPR, part = c % CPR;
          const bool ok = sPos[x0 + j] >= 0;
          const long long off = ok ? s.kv_off(w0 + x0 + j) + part * 8 : 0;
          tile::cp_async16(kd + j * LD + part * 8, kc + off, ok);
          tile::cp_async16(vd + j * LD + part * 8, vc + off, ok);
        }
      }
      tile::cp_async_commit();  // empty past the last tile: keeps the count
    };
    if (w0 != t_lo) {
#pragma unroll
      for (int k = 0; k < ST - 1; ++k) issue(k);
    }
    for (int k = 0; k < nl; ++k) {
      tile::cp_async_wait<ST - 2>();  // tile k landed (this thread's copies)
      __syncthreads();  // ... every thread's; tile k - 1's stage is free
      issue(k + ST - 1);
      attend(k % ST, sPos + tile_at(k));
    }
  }
  tile::cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: sAcc reuses it

  const int sw = warp / RW;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float sum = l[rr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int r = rw * 16 + g4 + 8 * rr;
    float* acc = sAcc + (sw * R + r) * LD;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(acc + n * 8 + 2 * t4) =
          make_float2(o[n][2 * rr], o[n][2 * rr + 1]);
    if (t4 == 0) {
      sM[sw * R + r] = m[rr];
      sL[sw * R + r] = sum;
    }
  }
  __syncthreads();
  // The block's state: its slot warps' folded in slot warp order, into
  // slot warp 0's rows (each element read and written by one thread).
  for (int c = tid; c < nr * (D / 4); c += NTB) {
    const int r = c / (D / 4), d = c % (D / 4) * 4;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < SW; ++w) M = fmaxf(M, sM[w * R + r]);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    float ls = 0.f;
#pragma unroll
    for (int w = 0; w < SW; ++w) {
      const float f = exp2f(sM[w * R + r] - M);  // a slot warp that saw nothing adds 0
      const float4 y = *reinterpret_cast<const float4*>(sAcc + (w * R + r) * LD + d);
      x.x += y.x * f;
      x.y += y.y * f;
      x.z += y.z * f;
      x.w += y.w * f;
      ls += sL[w * R + r] * f;
    }
    *reinterpret_cast<float4*>(sAcc + r * LD + d) = x;
    if (d == 0) {
      sMc[r] = M;
      sLc[r] = ls;
    }
  }
  __syncthreads();

  if constexpr (kCl) {
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    // Split s's shared memory (S == 1, no cluster: this block's own).
    auto at = [&](float* p, int sp) { return s.S > 1 ? cluster.map_shared_rank(p, sp) : p; };
    // Every split's state is in its block's shared memory (S == 1: the
    // block's own barrier above was enough).
    if (s.S > 1) cluster.sync();
    for (int r = split + s.S * warp; r < nr; r += s.S * NW) {
      const int i = s.last_fresh(r);
      // Every split's state of row r is read at once (one round trip over
      // the cluster, not one per split), then folded in split order.
      float ms[kMaxCluster], ls[kMaxCluster];
      float2 ys[kMaxCluster][E / 2];
#pragma unroll
      for (int sp = 0; sp < kMaxCluster; ++sp) {
        if (sp < s.S) {
          ms[sp] = at(sMc, sp)[r];
          ls[sp] = at(sLc, sp)[r];
          const float* acc = at(sAcc, sp) + r * LD + d0;
#pragma unroll
          for (int e = 0; e < E; e += 2) ys[sp][e / 2] = *reinterpret_cast<const float2*>(acc + e);
        }
      }
      float M = kNegInf;
#pragma unroll
      for (int sp = 0; sp < kMaxCluster; ++sp)
        if (sp < s.S) M = fmaxf(M, ms[sp]);
      for (int j = 0; j <= i; ++j) M = fmaxf(M, sSn[r * kMaxWin + j]);  // key 0: finite
      float den = 0.f, O[E];
#pragma unroll
      for (int e = 0; e < E; ++e) O[e] = 0.f;
#pragma unroll
      for (int sp = 0; sp < kMaxCluster; ++sp) {  // the splits, in split order
        if (sp < s.S) {
          const float sc = ms[sp] == kNegInf ? 0.f : exp2f(ms[sp] - M);
          den += ls[sp] * sc;
#pragma unroll
          for (int e = 0; e < E; e += 2) {
            O[e] += ys[sp][e / 2].x * sc;
            O[e + 1] += ys[sp][e / 2].y * sc;
          }
        }
      }
      for (int j = 0; j <= i; ++j) {  // the fresh keys, folded last
        const float pn = exp2f(sSn[r * kMaxWin + j] - M);
        den += pn;
#pragma unroll
        for (int e = 0; e < E; ++e) O[e] = fmaf(pn, to_f<T>(sVn[j * D + d0 + e]), O[e]);
      }
      T* out = s.o_row(r) + d0;
#pragma unroll
      for (int e = 0; e < E; ++e) out[e] = from_f<T>(O[e] / den);
    }
    if (s.S > 1) cluster.sync();  // no block leaves while others read its memory
  } else {
    // split_merge.cuh's workspace, indexed by flat row: state row row0 +
    // r * S; m in natural-log units.
    for (int c = tid; c < nr * (D / 4); c += NTB) {
      const int r = c / (D / 4), d = c % (D / 4) * 4;
      *reinterpret_cast<float4*>(s.ws + (s.row0 + (long long)r * s.S) * D + d) =
          *reinterpret_cast<const float4*>(sAcc + r * LD + d);
    }
    for (int r = tid; r < nr; r += NTB) {
      const long long row = s.row0 + (long long)r * s.S;
      s.ws[s.n_part * D + row] = sMc[r] == kNegInf ? kNegInf : sMc[r] * 0.6931471805599453f;
      s.ws[s.n_part * D + s.n_part + row] = sLc[r];
    }
  }
}

}  // namespace wt
}  // namespace llmss
