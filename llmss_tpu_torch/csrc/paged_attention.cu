// K3 and K4: attention over the paged KV block pool.
//
// Replaces two TPU kernels:
//   * llmss_tpu/ops/pallas_paged_decode.py::paged_decode_attention (K3):
//     single-token decode over the pool;
//   * llmss_tpu/ops/pallas_ragged.py::ragged_paged_attention (K4): a
//     CB-token query chunk per row of which q_len are live (1 for decode
//     rows, up to CB for rows streaming a prompt), its int8 branch
//     (`quant`, pallas_ragged.py:80-87, :144-145, :163-168) included.
//
// Function, for row b, KV head hk, query i < CB of the chunk and query head
// h = hk*G + g: one softmax over
//   * the STALE pool of layer `layer` (the chunk's own KV is not written
//     yet), through block_tables[b, j] for table columns
//     j < min(n_blocks[b], n_cols), sentinels clamped to block N-1; slot
//     t = j*bs + s is visible when its pre-write logical position p =
//     kv_pos[b, t] satisfies p >= 0, p <= q_pos[b] + i, p > q_pos[b] + i -
//     window (when a window is set), and t is not pending: its ring
//     distance from slot0[b], modulo MB*bs, is at least q_len[b] (that
//     range, which may wrap, is overwritten by the chunk's deferred write);
//   * the chunk's fresh keys jj < CB, visible when jj <= i, jj < q_len[b]
//     and (with a window) i - jj < window. Key 0 is visible to every query
//     row, so every denominator is positive and an empty row yields exactly
//     v_new.
// Query rows i >= q_len[b] are chunk padding that nothing reads: at CB > 1
// the chunk tile writes them as zeros (the Pallas kernel computes them as
// finite garbage); at CB == 1 a row with q_len 0 gets zeros from the merge.
// Numerics follow the Pallas kernels: fp32 scores and running max / sum /
// accumulators, masked scores at the finite fp32 minimum, probabilities of
// masked slots exactly 0, P rounded to the value dtype before the cache's
// P.V (over an int8 pool: P x v_scale, carried to 2^-16 relative on the
// tensor cores, unrounded on the lanes).
//
// Five templates; the wrapper picks one from the dtypes, CB and G alone
// (ops/paged_attention.py kernel_plan) and this file refuses any other
// pairing:
//
// bf16 queries at CB > 1 (K4 with prompt chunks), over a bf16 pool
// ("mma") or an int8 one ("mma_int8") -> paged_mma<KV, D, false>, the
// chunk tile of chunk_tile.cuh. What bounds it on the H100: bytes. Each
// (row, KV head) needs the row's live blocks once, shared by its q_len*G
// query rows; at the serve shapes that read is the whole bound, far under
// the ~295 flops per byte where the tensor cores would limit. One block per
// (row, KV head, 64 flat query rows f = i*G + g, split s of S): the row's
// read is split along the KV axis into S splits of `split` slots, planned
// from the bucketed read n_cols * bs alone (ops/split_plan.py chunk_plan),
// so no block walks a long row alone; splits past a row's occupied slots
// return at once, the row's last live split also folds the chunk's fresh
// keys (trailing tiles of <= 64 keys from k_new / v_new, their P rounded
// to bf16 like the cache's, where the Pallas kernel applies fresh V in
// fp32: one more rounding, which chip_smoke.py's 2^-7 relative tolerance
// bounds), a row's only live split writes its output, and otherwise
// chunk_merge, launched next, folds the live splits' fp32 states in split
// order. Within a split: visibility and table entries staged in shared
// memory, the first tiles copied before the positions are read, a
// three-stage cp.async ring at D <= 128 with Q in registers, and over an
// int8 pool int8 tiles widened into a double-buffered bf16 tile (exact),
// each score times its slot's K scale and P x v_scale as two bf16 terms,
// hi + lo, so it is carried to 2^-16 relative, not bf16's 2^-8 (the fresh
// keys take the same two terms with scale 1). A tile of at most 16 live
// flat rows (decode rows) puts its four warps on quarters of each tile's
// slots.
//
// bf16 queries and pool at CB == 1 (K3, and K4 all-decode) with G_TILE <=
// G <= GROUP_MAX_G query heads on a KV head (2 to 16, ops/split_plan.py)
// -> paged_group, the group tile of group_tile.cuh through a paged
// Source: 16 rows a row warp, the table's columns walked in place
// (sentinels clamped, n_blocks / n_cols bounding the walk), each split's
// states folded by split_merge with the fresh key in fp32 (a cluster fold
// of the splits lost to the merge on the H100, PERF.md). At Qwen2-7B's G = 7
// the lanes did fp32 FMA for 7 heads on every KV element and their time
// grew with G (0.0286, 0.0196, 0.0326 ms at G = 1, 4, 7: bound by the
// CUDA cores), and the 64-row tile below filled 7 of 64 rows.
//
// bf16 queries at CB == 1 with G > GROUP_MAX_G (StarCoder's 48), or G > 8
// over an int8 pool -> paged_mma<KV, D, kDecode = true>, the 64-row tile
// of attn_tile.cuh / attn_tile_i8.cuh. What bounds decode: bytes, each KV head's live slots once
// per (row, KV head); so the question is which template reads them once.
// The lanes take R <= 8 query rows a block (their fp32 state lives in
// registers), so at G = 48 (StarCoder's one KV head) 6 blocks each
// streamed the same KV head and each did fp32 FMA for its 8 heads; the
// tile takes 64 flat rows, the whole group, on the tensor cores (and beat
// the group tile at G = 48 on K2, PERF.md). One block per (row, KV head,
// 64 of the G query heads, split s of S); split s walks table columns [s*C, (s+1)*C)
// of the row in place (C = split / bs, the split a whole number of 64-slot
// tiles), reads no fresh key, and stores each query head's fp32 (m, l,
// acc) in split_merge.cuh's workspace; split_merge, always launched next,
// folds the live splits in split order and then the fresh key in fp32, so
// the fresh V stays fp32 as in the Pallas K3 (not a trailing bf16 tile as
// in K4's chunks). The cache's P is rounded to bf16 before P.V (over an
// int8 pool: the two bf16 terms). K3 and an all-decode K4 take the same
// plan and grid at CB = 1, so they stay bit-identical here too.
//
// fp32 at any CB, and CB == 1 with G < G_TILE (MHA) or fp32 queries (K3,
// and K4 all-decode) -> paged_fwd, the lane template below. It keeps fp32
// FMA: at MHA decode each (row, KV head) reads the row's live blocks once
// for its one query head, ~4 flops per KV byte, so bytes bound it; fp32 on
// the tensor cores would mean TF32; and FMA keeps the fresh V in fp32, as
// the Pallas kernel does. (Measured on the H100, PERF.md: at G = 1 the
// lanes are faster than both tiles.) K3 is its CB = 1 launch: the
// ragged masks then reduce exactly to the decode masks, so an all-decode
// batch through K4 at CB = 1 takes the same split plan, grids and
// instruction sequence as K3 and gives bit-identical outputs. Its design:
//   * one block per (row, KV head, tile of R <= 8 of the CB*G query rows,
//     split s of S along the KV axis: flash-decoding, csrc/
//     split_merge.cuh). Split s reads table columns [s*C, (s+1)*C), C =
//     split_slots / bs, of the row, in place at the layer offset of the
//     stacked pool: no per-layer slice and no gathered copy. Without the
//     split each block walked its row's whole table, so the batch's
//     longest row set the kernel's time (the 812-slot row's blocks did 13
//     iterations while a 33-slot row's did one), and at small batch or
//     GQA the B*Hkv blocks left most of the 132 SMs idle. The host picks
//     S from the bucketed read n_cols*bs (ops/split_plan.py), never from
//     n_blocks, so a bucket always launches one grid; splits at or past
//     a row's ceil(n_blocks*bs / split_slots) return at once;
//   * every load the KV loop needs first (the row's scalars, its query
//     rows, the first kStage slots' positions and table entries) is
//     issued before any is used, without waiting for n_blocks; positions
//     (masked to the candidates any row of the tile can see) and table
//     entries are staged in shared memory. A loop that read a slot's
//     position, then its table entry, then its K/V would chain three
//     dependent loads per slot; each ring stage issues its K/V copies at
//     once;
//   * each warp streams its slots' K and V rows through its own cp.async
//     ring of 4 stages (6 over an int8 cache) in shared memory (csrc/
//     split_merge.cuh LaneRing): the loads of all but one stage are in
//     flight while one is computed, and they hold no registers, so the
//     MHA instantiation fits three blocks on an SM; slots no row of the
//     tile can see are not copied, and a step no lane of the warp sees is
//     skipped;
//   * every lane group keeps its own running softmax per query row; the
//     partial states merge by shuffles, then through shared memory
//     (reusing the rings). At S = 1 the block folds in the fresh keys
//     there (up to the last key any row of the tile can see: one for a
//     decode row) and writes the output; at S > 1 (CB == 1 only) it stores
//     its fp32 (m, l, acc) and split_merge, launched next on the same
//     stream, folds the live splits in split order and then the fresh key.
//
// int8 pool under fp32 queries at any CB, and under bf16 queries at CB == 1
// with G <= 8 (KV = int8_t, the engine's kv_dtype="int8") -> paged_fwd
// over int8 rows
// ("lanes_int8"), with k_scale / v_scale [L, Np, bs, Hkv] fp32: the Pallas
// kernel's int8 branch. Each slot's score is multiplied by its K scale
// after the Q.K dot and before the mask; P is multiplied by the V scale
// and P.V runs in fp32 (P is not rounded). The fresh keys come from k_new
// / v_new in the query's dtype and are not scaled. The int8 rows move in
// one 16-byte copy per lane and step, a slot's two scales in one copy each
// per window, and each V row is widened once per step for all query rows,
// without conversion instructions (csrc/split_merge.cuh LaneRing<int8_t>,
// csrc/common.cuh Vec8<int8_t>). fp32
// queries stay here at CB > 1 (the tensor cores would mean TF32); at CB
// == 1 (K3 over an int8 pool) it computes what the reference's oracle
// paged_decode_attention(k_scale_layer=) does (the Pallas K3 takes no
// scales), split and merged as the 16-bit K3 is, and an all-decode K4 at
// CB = 1 is bitwise K3 over int8 too.

#include "attn_tile.cuh"
#include "attn_tile_i8.cuh"
#include "chunk_tile.cuh"
#include "common.cuh"
#include "group_tile.cuh"
#include "split_merge.cuh"

namespace llmss {
namespace {

constexpr int NWARP = 8;
constexpr int NT = NWARP * 32;

struct Args {
  const void* q;      // [B, CB, Hq, D]
  const void* kp;     // [L, Np, bs, Hkv, D]
  const void* vp;
  const void* kn;     // [B, CB, Hkv, D]
  const void* vn;
  void* o;            // [B, CB, Hq, D]
  const int* qpos;    // [B] position of query 0
  const int* qlen;    // [B] live queries, or null for all 1 (K3)
  const int* kvpos;   // [B, MB*bs] pre-write logical positions
  const int* tables;  // [B, MB]
  const int* nblk;    // [B] occupied table columns
  const int* slot0;   // [B] logical slot of query 0
  int layer, B, CB, Np, bs, MB, n_cols, Hq, Hkv;
  float scale;
  int window;  // <= 0: full causal
  // The split (paged_fwd only; last, so paged_mma's parameters keep
  // their offsets): partials (split_merge.cuh, null at S = 1), splits
  // along the KV axis and slots per split.
  float* ws;
  int S, split;
};

// The int8-pool instantiations of paged_fwd and paged_mma take Args and the
// per-(block, slot, KV head) scales [L, Np, bs, Hkv]; the others take Args alone, as
// before the int8 pool (a parameter struct that grew, even at its end,
// changed their register allocation and slowed K3 by up to 17%, PERF.md).
struct ArgsI8 : Args {
  const float* ks;
  const float* vs;
};
template <typename KV> using ArgsOf = std::conditional_t<kQuant<KV>, ArgsI8, Args>;

template <typename KV, int D, int R>
struct Cfg {
  static constexpr int LPS = D / 8;          // lanes per slot (8 elements each)
  static constexpr int SPW = 32 / LPS;       // slots per warp per step
  static constexpr int STEP = NWARP * SPW;   // slots per step of the block
  static constexpr int SLOTS = STEP * kSteps;  // slots per ring stage
  // The warps' K/V rings, reused by s_acc [NWARP][R][D] once the KV loop
  // is done | s_m, s_l, s_wsc [NWARP][R] | s_den [R], pad [R] | s_w [R][CB]
  // | staged positions and table entries (dynamic)
  static constexpr size_t ring = size_t(NWARP) * LaneRing<KV>::WARP_BYTES;
  static constexpr size_t acc = sizeof(float) * NWARP * R * D;
  static constexpr size_t region = ring > acc ? ring : acc;
  static constexpr size_t fixed = region + sizeof(float) * (3 * NWARP * R + 2 * R);
};

// T: the query / fresh KV / output type; KV: the pool's (T, or int8_t).
template <typename T, typename KV, int D, int R>
__global__ void __launch_bounds__(NT, kLaneMinBlocks<T, R>) paged_fwd(ArgsOf<KV> a) {
  using C = Cfg<KV, D, R>;
  using Ring = LaneRing<KV>;
  constexpr int LPS = C::LPS, SPW = C::SPW;
  static_assert(!kQuant<KV> || NWARP * LaneRing<int8_t>::SCALE_SLOTS >= kStage);
  extern __shared__ __align__(16) float smem[];
  float* s_acc = smem;                  // [NWARP][R][D], after the KV loop
  float* s_m = smem + C::region / sizeof(float);  // [NWARP][R]
  float* s_l = s_m + NWARP * R;         // [NWARP][R]
  float* s_wsc = s_l + NWARP * R;       // [NWARP][R] scale of each partial
  float* s_den = s_wsc + NWARP * R;     // [R]
  float* s_w = s_den + 2 * R;           // [R][CB] fresh-key weights
  int* s_pos = reinterpret_cast<int*>(s_w + R * a.CB);  // [kStage]
  int* s_blk = s_pos + kStage;          // [kStage / bs + 2]

  pdl_trigger();  // split_merge may start; it waits for this grid's writes

  const T* q = static_cast<const T*>(a.q);
  const KV* kp = static_cast<const KV*>(a.kp);
  const KV* vp = static_cast<const KV*>(a.vp);
  const T* kn = static_cast<const T*>(a.kn);
  const T* vn = static_cast<const T*>(a.vn);
  T* o = static_cast<T*>(a.o);

  const int b = blockIdx.x;
  const int G = a.Hq / a.Hkv;
  const int nrows = a.CB * G;  // flat query rows f = i*G + g of this KV head
  const int tiles = (nrows + R - 1) / R;
  const int hk = blockIdx.y / tiles;
  const int f0 = (blockIdx.y % tiles) * R;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPS, part = lane % LPS;
  const int e0 = part * 8;

  const bool partial = a.S > 1;  // store split state for split_merge
  const int split = blockIdx.z;
  const int t_lo = split * a.split;
  // The split's slots before n_blocks is known: staging starts without it.
  const int t_cap = min(a.n_cols * a.bs, t_lo + a.split);
  const int ring = a.MB * a.bs;
  const int* kvp = a.kvpos + (long long)b * ring;
  const int* bt = a.tables + (long long)b * a.MB;

  int qi[R];
  bool live[R];
  int i_lo = 0x7fffffff, i_hi = -1;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int f = f0 + r;
    live[r] = f < nrows;
    qi[r] = live[r] ? f / G : 0;
    if (live[r]) {
      i_lo = min(i_lo, qi[r]);
      i_hi = max(i_hi, qi[r]);
    }
  }

  // Every load the KV loop needs first is issued here, before any is
  // used: the row's scalars, its query rows, and the first window's
  // positions and table entries (kStage / NT and one per thread).
  constexpr int PPT = kStage / NT;
  int pv[PPT], bv = 0, pb[PPT];  // pb: int8 only
  auto load_window = [&](int w0, int ws1) {
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int t = w0 + j * NT + threadIdx.x;
      pv[j] = t < ws1 ? kvp[t] : -1;
    }
    const int c = w0 / a.bs + threadIdx.x;
    if (c <= (ws1 - 1) / a.bs) bv = bt[c];
    if constexpr (kQuant<KV>) {  // the blocks of this thread's slots, for their scales
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const int t = w0 + j * NT + threadIdx.x;
        pb[j] = t < ws1 ? bt[t / a.bs] : 0;
      }
    }
  };
  const int qp = a.qpos[b];
  const int ql = a.qlen ? a.qlen[b] : 1;
  const int sl0 = a.slot0[b];
  const int nb = a.nblk[b];
  Vec8<T> qv[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (live[r])
      qv[r].load(q + ((long long)(b * a.CB + qi[r]) * a.Hq + hk * G + (f0 + r) % G) * D + e0);
  if (t_lo < t_cap) load_window(t_lo, min(t_cap, t_lo + kStage));

  const int ncols = min(max(nb, 0), a.n_cols);
  const int t_end = ncols * a.bs;
  const int t_hi = min(t_end, t_lo + a.split);

  if (i_lo >= ql) {  // a tile of chunk padding only: nobody reads it
    if (partial) return;  // split_merge writes its zeros
    for (int idx = threadIdx.x; idx < R * D; idx += NT) {
      const int f = f0 + idx / D;
      if (f < nrows)
        o[((long long)(b * a.CB + f / G) * a.Hq + hk * G + f % G) * D + idx % D] =
            from_f<T>(0.f);
    }
    return;
  }
  // A split past the row's occupied columns: split_merge skips it.
  if (partial && t_lo >= t_end) return;
  // Fresh keys past jmax are invisible to every row of the tile.
  const int jmax = min(ql, i_hi + 1);

  float qf[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (live[r]) {
      qv[r].to_float(qf[r]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[r][e] = 0.f;
    }
  }

  float m[R], l[R], acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[r][e] = 0.f;
  }

  const long long slot_stride = (long long)a.Hkv * D;
  const long long blk_stride = (long long)a.bs * slot_stride;
  const long long base =
      (long long)a.layer * a.Np * blk_stride + (long long)hk * D + e0;
  const int last_blk = a.Np - 2;  // N - 1: block N is the write drop target
  char* wring = reinterpret_cast<char*>(smem) + warp * Ring::WARP_BYTES;
  // int8 only: the ring stage step() reads its V rows from, and the index
  // of its first slot in the window's scales (read where they are used:
  // held from the read-back, they raised the R = 2 instantiations' spills
  // at their 80 registers).
  int st8 = 0, sk = 0;
  // int8 only: the start of this lane's 16-byte copies, the K row (even
  // lane) or V row (odd) of its pair of lanes, less the slot's offset.
  const KV* src8 = lane & 1 ? vp + (base - 8) : kp + base;

  // Fold one step's slots (K/V rows read back from the ring; int8: K rows,
  // its V rows and scales read here) into each row's running softmax;
  // pp[u] < 0: no row of the tile sees slot u.
  auto step = [&](const Vec8<KV>(&kv)[kSteps], const Vec8<KV>(&vv)[kSteps],
                  const int(&pp)[kSteps]) {
    float s[kSteps][R];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      float kf[8];
      if (pp[u] >= 0) kv[u].to_float(kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float d = 0.f;
        if (pp[u] >= 0) {
#pragma unroll
          for (int e = 0; e < 8; ++e) d = fmaf(qf[r][e], kf[e], d);
        }
#pragma unroll
        for (int off = LPS / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        const bool vis = pp[u] >= 0 && live[r] && pp[u] <= qp + qi[r] &&
                         (a.window <= 0 || pp[u] > qp + qi[r] - a.window);
        if constexpr (kQuant<KV>) {
          s[u][r] = vis ? d * a.scale * *Ring::scale_at(wring, 0, sk + u * SPW) : kNegInf;
        } else {
          s[u][r] = vis ? d * a.scale : kNegInf;
        }
      }
    }
    if constexpr (kQuant<KV>) {
      // int8: every row's rescale first, then slot by slot, so that each
      // V row is widened once for all of them (per row, the same
      // operations in the same order as below). P times the slot's V
      // scale, in fp32, as the Pallas int8 branch's P.V.
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float m_new = m[r];
#pragma unroll
        for (int u = 0; u < kSteps; ++u) m_new = fmaxf(m_new, s[u][r]);
        if (m_new == kNegInf) continue;  // nothing visible yet in this stream
        const float alpha = expf(m[r] - m_new);
        l[r] *= alpha;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] *= alpha;
        m[r] = m_new;
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (pp[u] < 0) continue;  // no row of the tile sees slot u
        float vf[8];
        Vec8<KV> v8;
        ring_get(v8, wring, st8, u, 1, lane);
        v8.to_float(vf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (s[u][r] == kNegInf) continue;  // masked slots contribute 0
          const float p = expf(s[u][r] - m[r]);
          l[r] += p;
          const float pr = p * *Ring::scale_at(wring, 1, sk + u * SPW);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(pr, vf[e], acc[r][e]);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float m_new = m[r];
#pragma unroll
        for (int u = 0; u < kSteps; ++u) m_new = fmaxf(m_new, s[u][r]);
        if (m_new == kNegInf) continue;  // nothing visible yet in this stream
        const float alpha = expf(m[r] - m_new);
        l[r] *= alpha;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] *= alpha;
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          if (s[u][r] == kNegInf) continue;  // masked slots contribute 0
          const float p = expf(s[u][r] - m_new);
          l[r] += p;
          const float pr = round_to<KV>(p);
          float vf[8];
          vv[u].to_float(vf);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(pr, vf[e], acc[r][e]);
        }
        m[r] = m_new;
      }
    }
  };

  for (int w0 = t_lo; w0 < t_hi; w0 += kStage) {
    const int ws1 = min(t_cap, w0 + kStage), w1 = min(t_hi, ws1);
    if (w0 != t_lo) load_window(w0, ws1);
    __syncthreads();  // the previous window's staged slots are consumed
    // Stage positions (-1 unless some row of the tile may see the slot)
    // and table entries.
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int i = j * NT + threadIdx.x, t = w0 + i, p = pv[j];
      int d = t - sl0;
      if (d < 0) d += ring;
      s_pos[i] = t < w1 && p >= 0 && d >= ql && p <= qp + i_hi &&
                         (a.window <= 0 || p > qp + i_lo - a.window)
                     ? p
                     : -1;
      if constexpr (kQuant<KV>) {
        // The slot's scales ([L, Np, bs, Hkv]), in issue(0)'s group, to
        // where its warp reads them: slot i is step i / STEP of warp (i %
        // STEP) / SPW, sub i % SPW (csrc/split_merge.cuh LaneRing<int8_t>).
        if (s_pos[i] >= 0) {
          const long long so =
              (((long long)a.layer * a.Np + min(pb[j], last_blk)) * a.bs + t % a.bs) * a.Hkv + hk;
          Ring::put_scales(reinterpret_cast<char*>(smem) + (i % C::STEP) / SPW * Ring::WARP_BYTES,
                           i / C::STEP * SPW + i % SPW, a.ks + so, a.vs + so);
        }
      }
    }
    const int c0 = w0 / a.bs;
    if (threadIdx.x <= (ws1 - 1) / a.bs - c0) s_blk[threadIdx.x] = min(bv, last_blk);
    __syncthreads();

    // Ring stage i holds the window's slots [i * SLOTS, (i + 1) * SLOTS):
    // slot w0 + (i * kSteps + u) * STEP + warp * SPW + sub for this lane.
    const int n_st = (w1 - w0 + C::SLOTS - 1) / C::SLOTS;
    auto slot = [&](int i, int u) { return w0 + (i * kSteps + u) * C::STEP + warp * SPW + sub; };
    auto issue = [&](int i) {
      if (i < n_st) {
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          const int t = slot(i, u);
          if (t < w1 && s_pos[t - w0] >= 0) {
            if constexpr (kQuant<KV>) {
              Ring::put(wring, i % Ring::STAGES, u, lane,
                        src8 + ((long long)s_blk[t / a.bs - c0] * blk_stride +
                                (long long)(t % a.bs) * slot_stride));
            } else {
              const long long off = base + (long long)s_blk[t / a.bs - c0] * blk_stride +
                                    (long long)(t % a.bs) * slot_stride;
              Ring::put(wring, i % Ring::STAGES, u, lane, kp + off, vp + off);
            }
          }
        }
      }
      tile::cp_async_commit();  // empty past the window: keeps the count
    };
#pragma unroll
    for (int i = 0; i < Ring::STAGES - 1; ++i) issue(i);
    for (int i = 0; i < n_st; ++i) {
      // int8: every lane of the warp is done reading the stage issue()
      // copies into (csrc/split_merge.cuh has the ordering argument).
      if constexpr (kQuant<KV>) __syncwarp();
      issue(i + Ring::STAGES - 1);
      tile::cp_async_wait<Ring::STAGES - 1>();  // this lane's stage i landed
      // int8: and every lane's; at i = 0 every thread's scale copies too.
      if constexpr (kQuant<KV>) {
        if (i == 0) {
          __syncthreads();
        } else {
          __syncwarp();
        }
      }
      Vec8<KV> kv[kSteps], vv[kSteps];
      int pp[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int t = slot(i, u);
        pp[u] = t < w1 ? s_pos[t - w0] : -1;
        if (pp[u] >= 0) {
          ring_get(kv[u], wring, i % Ring::STAGES, u, 0, lane);
          // int8: step() reads the V row where it widens it.
          if constexpr (!kQuant<KV>) ring_get(vv[u], wring, i % Ring::STAGES, u, 1, lane);
        }
      }
      if constexpr (kQuant<KV>) st8 = i % Ring::STAGES, sk = i * kSteps * SPW + sub;
      bool any = false;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) any |= pp[u] >= 0;
      // A step no lane of the warp sees leaves the state as it is.
      if (__any_sync(0xffffffffu, any)) step(kv, vv, pp);
    }
  }

  // Merge the SPW slot streams of this warp (lanes differing in `sub`).
#pragma unroll
  for (int off = LPS; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mm = fmaxf(m[r], m_o);
      const float x = expf(m[r] - mm), y = expf(m_o - mm);
      l[r] = l[r] * x + l_o * y;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        acc[r][e] = acc[r][e] * x + acc_o * y;
      }
      m[r] = mm;
    }
  }
  __syncthreads();  // every warp is done with its ring: s_acc reuses it
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        s_acc[(warp * R + r) * D + e0 + e] = acc[r][e];
      if (part == 0) {
        s_m[warp * R + r] = m[r];
        s_l[warp * R + r] = l[r];
      }
    }
  }
  if (partial) {  // CB == 1: flat row f is query head hk*G + f
    __syncthreads();
    store_partial<NWARP, D, R>(s_acc, s_m, s_l, a.ws, a.B, a.Hq, a.S, b, split,
                               [&](int r) { return f0 + r < nrows ? hk * G + f0 + r : -1; });
    return;
  }

  // Fresh-key scores: warp w takes (row, key) pairs w, w + NWARP, ...
  const int CB = a.CB;
  for (int pr = warp; pr < R * jmax; pr += NWARP) {
    const int r = pr / jmax, jj = pr % jmax;
    const int f = f0 + r;
    const bool row_live = f < nrows;
    const int i = row_live ? f / G : 0;
    float d = 0.f;
    if (row_live) {
      const T* qh = q + ((long long)(b * CB + i) * a.Hq + hk * G + f % G) * D;
      const T* kh = kn + ((long long)(b * CB + jj) * a.Hkv + hk) * D;
      for (int e = lane; e < D; e += 32) d = fmaf(to_f<T>(qh[e]), to_f<T>(kh[e]), d);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    const bool vis = row_live && jj <= i && jj < ql &&
                     (a.window <= 0 || i - jj < a.window);
    if (lane == 0) s_w[r * CB + jj] = vis ? d * a.scale : kNegInf;
  }
  __syncthreads();

  // Per row: combine the warps' partial states with the fresh keys into
  // one softmax; the scores become weights in place.
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) M = fmaxf(M, s_m[w * R + r]);
    float Mf = M;
    for (int jj = 0; jj < jmax; ++jj) Mf = fmaxf(Mf, s_w[r * CB + jj]);
    float den = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const float sc = s_m[w * R + r] == kNegInf ? 0.f : expf(s_m[w * R + r] - Mf);
      s_wsc[w * R + r] = sc;
      den += s_l[w * R + r] * sc;
    }
    for (int jj = 0; jj < jmax; ++jj) {
      const float sv = s_w[r * CB + jj];
      const float wgt = sv == kNegInf ? 0.f : expf(sv - Mf);
      s_w[r * CB + jj] = wgt;
      den += wgt;
    }
    s_den[r] = den;
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < R * D; idx += NT) {
    const int r = idx / D, d = idx % D;
    const int f = f0 + r;
    if (f >= nrows) continue;
    const int i = f / G;
    float O = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) O += s_acc[(w * R + r) * D + d] * s_wsc[w * R + r];
    const T* vh = vn + ((long long)b * CB * a.Hkv + hk) * D + d;
    for (int jj = 0; jj < jmax; ++jj) {
      const float wgt = s_w[r * CB + jj];
      if (wgt != 0.f) O = fmaf(wgt, to_f<T>(vh[(long long)jj * a.Hkv * D]), O);
    }
    o[((long long)(b * CB + i) * a.Hq + hk * G + f % G) * D + d] = from_f<T>(O / s_den[r]);
  }
}

// The split kernel, then at S > 1 split_merge on the same stream. A split
// is whole ring stages of whole table columns, S splits cover the read,
// and only CB == 1 splits (its merge folds the one fresh key).
template <typename T, typename KV, int D, int R>
cudaError_t launch(const ArgsI8& a, cudaStream_t stream) {
  if (a.S < 1 || a.S > kMaxSplits || a.split <= 0 ||
      a.split % Cfg<KV, D, R>::SLOTS || a.split % a.bs ||
      (long long)a.S * a.split < (long long)a.n_cols * a.bs ||
      (a.S > 1 && (a.CB != 1 || a.ws == nullptr)) ||
      (kQuant<KV> && (a.ks == nullptr || a.vs == nullptr)))
    return cudaErrorInvalidValue;
  const size_t smem =
      Cfg<KV, D, R>::fixed + sizeof(float) * size_t(R) * a.CB + stage_bytes(a.bs);
  auto kern = paged_fwd<T, KV, D, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.CB * (a.Hq / a.Hkv) + R - 1) / R;
  dim3 grid(a.B, a.Hkv * tiles, a.S);
  kern<<<grid, NT, smem, stream>>>(static_cast<const ArgsOf<KV>&>(a));
  err = cudaGetLastError();
  if (err != cudaSuccess || a.S == 1) return err;
  const MergeArgs m{a.q, a.kn, a.vn, a.o, a.ws, a.nblk, a.qlen, a.B, a.Hq,
                    a.Hkv, a.S, a.split, a.bs, a.n_cols, a.scale};
  return launch_merge<T>(D, m, stream);
}

template <typename T, typename KV, int D>
cudaError_t dispatch_r(int R, const ArgsI8& a, cudaStream_t s) {
  switch (R) {
    case 1: return launch<T, KV, D, 1>(a, s);
    case 2: return launch<T, KV, D, 2>(a, s);
    case 4: return launch<T, KV, D, 4>(a, s);
    case 8: return launch<T, KV, D, 8>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename KV>
cudaError_t dispatch_d(int D, int R, const ArgsI8& a, cudaStream_t s) {
  switch (D) {
    case 64: return dispatch_r<T, KV, 64>(R, a, s);
    case 128: return dispatch_r<T, KV, 128>(R, a, s);
    case 256: return dispatch_r<T, KV, 256>(R, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// -- bf16 queries at CB > 1: the tensor-core tiles --------------------------

// tile::attend's Source for one block: flat rows f0 .. f0+63 of row b and
// KV head hk. Tiles [0, n_cache) gather the pool through the row's table
// (slots past t_end zero-filled, pending or empty ones hidden by position
// -1); the rest read the fresh keys jj < jmax, whose position is qp + jj.
template <int D>
struct PagedSrc {
  using T = __nv_bfloat16;
  const T *q, *kp, *vp, *kn, *vn;
  T* o;
  const int *kvp, *bt;  // row b's positions and table
  int b, hk, G, f0, nrows, CB, Hq, Hkv, qp, ql, sl0, ring, t_end, jmax;
  int bs, last_blk, n_cache;
  long long base, blk_stride, slot_stride;
  int n_tiles, qmax, qmin, window;
  float scale_log2;

  __device__ bool has(int r) const { return f0 + r < nrows; }
  __device__ long long q_off(int r) const {
    const int f = f0 + r;
    return ((long long)(b * CB + f / G) * Hq + hk * G + f % G) * D;
  }
  __device__ const T* q_row(int r) const { return has(r) ? q + q_off(r) : nullptr; }
  __device__ int q_pos(int r) const { return has(r) ? qp + (f0 + r) / G : -1; }
  __device__ T* o_row(int r) const { return has(r) ? o + q_off(r) : nullptr; }
  __device__ int slot_pos(int t, int j) const {
    if (t >= n_cache) {
      const int jj = (t - n_cache) * tile::kSlots + j;
      return jj < jmax ? qp + jj : -1;
    }
    const int x = t * tile::kSlots + j;
    if (x >= t_end) return -1;
    int d = x - sl0;
    if (d < 0) d += ring;
    return d >= ql ? kvp[x] : -1;
  }
  __device__ bool rows(int t, int j, const T*& kr, const T*& vr) const {
    long long off;
    if (t >= n_cache) {
      const int jj = (t - n_cache) * tile::kSlots + j;
      if (jj >= jmax) return false;
      off = ((long long)(b * CB + jj) * Hkv + hk) * D;
      kr = kn + off;
      vr = vn + off;
      return true;
    }
    const int x = t * tile::kSlots + j;
    if (x >= t_end) return false;
    const int blk = min(bt[x / bs], last_blk);
    off = base + blk * blk_stride + (long long)(x % bs) * slot_stride;
    kr = kp + off;
    vr = vp + off;
    return true;
  }
  __device__ const T* any_ptr() const { return kn; }
};

// tile::attend_i8's Source over an int8 pool: PagedSrc (kp / vp unused;
// fresh tiles through its rows()), the pool's int8 rows and its scales
// [L, Np, bs, Hkv], whose offset is the row's element offset / D.
template <int D>
struct PagedSrcI8 : PagedSrc<D> {
  const int8_t *kq, *vq;
  const float *ks, *vs;

  __device__ bool rows8(int t, int j, const int8_t*& kr, const int8_t*& vr,
                        long long& so) const {
    const int x = t * tile::kSlots + j;
    if (x >= this->t_end) return false;
    const int blk = min(this->bt[x / this->bs], this->last_blk);
    const long long off =
        this->base + blk * this->blk_stride + (long long)(x % this->bs) * this->slot_stride;
    kr = kq + off;
    vr = vq + off;
    so = off / D;
    return true;
  }
};

// One block of K4 at CB > 1 on the chunk tile (chunk_tile.cuh): flat rows
// of query tile z % tiles of row b under KV head hk against split S - 1 -
// z / tiles of the row's occupied slots. A tile of chunk padding only is
// written as zeros by its split 0; splits past the row's occupied slots
// return; the row's last live split also folds the fresh keys, and a
// row's only live split writes the output (else its state goes to the
// workspace, for chunk_merge, and split 0 writes the tile's padding rows).
template <typename KV, int D>
__device__ __forceinline__ void chunk_block(const ArgsOf<KV>& a) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char chunk_smem[];
  pdl_trigger();  // chunk_merge may start; it waits for this grid's writes
  chunk::Chunk<KV> s;
  // Later splits first: grid z = (S - 1 - split) * tiles + query tile.
  const int tiles = (a.CB * (a.Hq / a.Hkv) + chunk::kRows - 1) / chunk::kRows;
  const int b = blockIdx.x, hk = blockIdx.y;
  const int split = a.S - 1 - (int)blockIdx.z / tiles;
  s.b = b;
  s.hk = hk;
  s.G = a.Hq / a.Hkv;
  s.CB = a.CB;
  s.Hq = a.Hq;
  s.Hkv = a.Hkv;
  s.f0 = blockIdx.z % tiles * chunk::kRows;
  s.nrows = a.CB * s.G;
  // The row's scalars at once: a block past them returns after one load.
  s.ql = a.qlen[b];
  const int nb = a.nblk[b];
  s.qp = a.qpos[b];
  s.sl0 = a.slot0[b];
  s.q = static_cast<const T*>(a.q);
  s.o = static_cast<T*>(a.o);
  s.i_lo = s.f0 / s.G;
  if (s.i_lo >= s.ql) {  // a tile of chunk padding only: nobody reads it
    if (split != 0) return;
    for (int c = threadIdx.x; c < chunk::kRows * (D / 8); c += chunk::kThreads) {
      const int f = s.f0 + c / (D / 8);
      if (f < s.nrows)
        *reinterpret_cast<uint4*>(
            s.o + ((long long)(b * a.CB + f / s.G) * a.Hq + hk * s.G + f % s.G) * D +
            c % (D / 8) * 8) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  const int live = chunk::live_splits(nb, a.n_cols, a.bs, a.split);
  if (split >= live) return;  // past the row's occupied slots
  s.i_hi = min((min(s.f0 + chunk::kRows, s.nrows) - 1) / s.G, s.ql - 1);
  s.t_lo = split * a.split;
  s.t_hi = min(min(max(nb, 0), a.n_cols) * a.bs, s.t_lo + a.split);
  // Fresh keys past i_hi are invisible to every row of the tile.
  s.jmax = split == live - 1 ? min(s.ql, s.i_hi + 1) : 0;
  s.finish = live == 1;
  s.kp = static_cast<const KV*>(a.kp);
  s.vp = static_cast<const KV*>(a.vp);
  if constexpr (kQuant<KV>) {
    s.ks = a.ks;
    s.vs = a.vs;
  } else {
    s.ks = s.vs = nullptr;
  }
  s.kn = static_cast<const T*>(a.kn);
  s.vn = static_cast<const T*>(a.vn);
  s.ring = a.MB * a.bs;
  s.window = a.window;
  s.bs = a.bs;
  s.last_blk = a.Np - 2;  // N - 1: block N is the write drop target
  s.kvp = a.kvpos + (long long)b * s.ring;
  s.bt = a.tables + (long long)b * a.MB;
  s.slot_stride = (long long)a.Hkv * D;
  s.blk_stride = (long long)a.bs * s.slot_stride;
  s.base = (long long)a.layer * a.Np * s.blk_stride + (long long)hk * D;
  s.scale_log2 = a.scale * 1.4426950408889634f;
  s.ws = a.ws;
  s.n_part = (long long)a.B * a.CB * a.Hq * a.S;
  s.S = a.S;
  s.split = split;
  chunk::run<KV, D>(s, chunk_smem);
}

// K4 at CB > 1 runs the chunk tile, but over an int8 pool at D 256, where
// the 64-row tile's chunk form (attend_i8, unsplit) stayed faster on the
// H100 (PERF.md; the chunk tile's int8 form there keeps one widened tile
// beside Q in shared memory and spills).
template <typename KV, int D> constexpr bool kChunkTile = !(kQuant<KV> && D > 128);

// KV: the pool's type, bf16 (attn_tile.cuh) or int8 (attn_tile_i8.cuh).
// kDecode false (CB > 1): the chunk tile (chunk_block) where kChunkTile,
// else one block per (row, KV head, 64 flat query rows) walking the row
// unsplit, then the fresh keys. kDecode (CB == 1: K3, and an all-decode
// K4): blockIdx.z is a 64-row tile of the G query heads times split s of
// S; the block reads table columns [s * split / bs, (s + 1) * split / bs)
// of row b, no fresh key, and leaves its fp32 partial states for
// split_merge.
template <typename KV, int D, bool kDecode>
__global__ void __launch_bounds__(tile::kThreads) paged_mma(ArgsOf<KV> a) {
  if constexpr (!kDecode && kChunkTile<KV, D>) {
    chunk_block<KV, D>(a);
  } else {
  using T = __nv_bfloat16;
  using Base = std::conditional_t<kQuant<KV>, PagedSrcI8<D>, PagedSrc<D>>;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int b = blockIdx.x, hk = blockIdx.y;
  std::conditional_t<kDecode, tile::WithPartial<Base>, Base> s;
  s.G = a.Hq / a.Hkv;
  s.b = b;
  s.hk = hk;
  s.CB = a.CB;
  s.Hq = a.Hq;
  s.Hkv = a.Hkv;
  if constexpr (kDecode) {
    pdl_trigger();  // split_merge may start; it waits for this grid's writes
    s.f0 = blockIdx.z / a.S * tile::kRows;
    s.ql = a.qlen ? a.qlen[b] : 1;
  } else {
    s.f0 = blockIdx.z * tile::kRows;
    s.ql = a.qlen[b];
  }
  s.nrows = a.CB * s.G;
  const int i_lo = s.f0 / s.G;
  const int i_hi = (min(s.f0 + tile::kRows, s.nrows) - 1) / s.G;
  s.q = static_cast<const T*>(a.q);
  s.o = static_cast<T*>(a.o);
  if (i_lo >= s.ql) {  // a tile of chunk padding only: nobody reads it
    if constexpr (kDecode) return;  // split_merge writes its zeros
    for (int idx = threadIdx.x; idx < tile::kRows * D; idx += tile::kThreads) {
      const int r = idx / D;
      if (s.has(r)) s.o[s.q_off(r) + idx % D] = from_f<T>(0.f);
    }
    return;
  }
  if constexpr (kQuant<KV>) {
    s.kp = s.vp = nullptr;
    s.kq = static_cast<const int8_t*>(a.kp);
    s.vq = static_cast<const int8_t*>(a.vp);
    s.ks = a.ks;
    s.vs = a.vs;
  } else {
    s.kp = static_cast<const T*>(a.kp);
    s.vp = static_cast<const T*>(a.vp);
  }
  s.kn = static_cast<const T*>(a.kn);
  s.vn = static_cast<const T*>(a.vn);
  s.qp = a.qpos[b];
  s.sl0 = a.slot0[b];
  s.ring = a.MB * a.bs;
  s.bs = a.bs;
  s.t_end = min(max(a.nblk[b], 0), a.n_cols) * a.bs;
  s.jmax = min(s.ql, i_hi + 1);  // fresh keys past it: invisible to all rows
  s.kvp = a.kvpos + (long long)b * s.ring;
  s.bt = a.tables + (long long)b * a.MB;
  if constexpr (kDecode) {
    // The split's slots [t_lo, t_hi) as slots [0, t_hi - t_lo) of a row
    // that starts at t_lo: t_lo is whole table columns, and the pending
    // slot's ring distance is unchanged. The fresh key is split_merge's.
    const int split = blockIdx.z % a.S, t_lo = split * a.split;
    if (t_lo >= s.t_end) return;  // past the row's occupied slots: skipped
    s.t_end = min(s.t_end, t_lo + a.split) - t_lo;
    s.kvp += t_lo;
    s.bt += t_lo / a.bs;
    s.sl0 -= t_lo;
    s.jmax = 0;
    s.part = {a.ws, (long long)a.B * a.Hq * a.S,
              ((long long)b * a.Hq + hk * s.G + s.f0) * a.S + split, a.S,
              min(tile::kRows, s.nrows - s.f0)};
  }
  s.last_blk = a.Np - 2;  // N - 1: block N is the write drop target
  s.slot_stride = (long long)a.Hkv * D;
  s.blk_stride = (long long)a.bs * s.slot_stride;
  s.base = (long long)a.layer * a.Np * s.blk_stride + (long long)hk * D;
  s.n_cache = (s.t_end + tile::kSlots - 1) / tile::kSlots;
  s.n_tiles = s.n_cache + (s.jmax + tile::kSlots - 1) / tile::kSlots;
  s.qmax = s.qp + i_hi;
  s.qmin = s.qp + i_lo;
  s.window = a.window;
  s.scale_log2 = a.scale * 1.4426950408889634f;
  if constexpr (kQuant<KV>) {
    tile::attend_i8<D>(s, tile_smem);
  } else {
    tile::attend<T, D, true>(s, tile_smem);
  }
  }
}

// At CB == 1 the 64-row tile in S splits of `split` slots, whole 64-slot
// tiles and table columns covering the read, then split_merge on the same
// stream, whatever S.
template <typename KV, int D>
cudaError_t launch_decode_mma(const ArgsI8& a, cudaStream_t stream) {
  if ((kQuant<KV> && (a.ks == nullptr || a.vs == nullptr)) || a.CB != 1 || a.S < 1 ||
      a.S > kMaxSplits || a.split <= 0 || a.split % tile::kSlots || a.split % a.bs ||
      a.ws == nullptr || (long long)a.S * a.split < (long long)a.n_cols * a.bs)
    return cudaErrorInvalidValue;
  constexpr size_t smem = kQuant<KV> ? tile::SmemI8<D>::bytes : tile::Smem<D>::bytes;
  auto kern = paged_mma<KV, D, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.Hq / a.Hkv + tile::kRows - 1) / tile::kRows;
  dim3 grid(a.B, a.Hkv, tiles * a.S);
  kern<<<grid, tile::kThreads, smem, stream>>>(static_cast<const ArgsOf<KV>&>(a));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const MergeArgs m{a.q, a.kn, a.vn, a.o, a.ws, a.nblk, a.qlen, a.B, a.Hq,
                    a.Hkv, a.S, a.split, a.bs, a.n_cols, a.scale};
  return launch_merge<__nv_bfloat16>(D, m, stream);
}

// The chunk tile in S splits of `split` slots (whole 64-slot tiles and
// table columns covering the read), then, at S > 1, chunk_merge on the
// same stream (a programmatic dependent launch).
template <typename KV, int D>
cudaError_t launch_chunk_tile(const ArgsI8& a, cudaStream_t stream) {
  if ((kQuant<KV> && (a.ks == nullptr || a.vs == nullptr)) || a.CB < 2 ||
      a.qlen == nullptr || a.S < 1 || a.S > kMaxSplits || a.split <= 0 ||
      a.split % chunk::kSlots || a.split % a.bs || (a.S > 1 && a.ws == nullptr) ||
      (long long)a.S * a.split < (long long)a.n_cols * a.bs)
    return cudaErrorInvalidValue;
  constexpr size_t smem = chunk::Smem<KV, D>::bytes;
  auto kern = paged_mma<KV, D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.CB * (a.Hq / a.Hkv) + chunk::kRows - 1) / chunk::kRows;
  dim3 grid(a.B, a.Hkv, tiles * a.S);
  kern<<<grid, chunk::kThreads, smem, stream>>>(static_cast<const ArgsOf<KV>&>(a));
  err = cudaGetLastError();
  if (err != cudaSuccess || a.S == 1) return err;
  const chunk::MergeArgs m{a.o, a.ws, a.qlen, a.nblk, a.B, a.CB, a.Hq,
                           a.Hkv, a.S, a.split, a.bs, a.n_cols};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B, a.Hkv, tiles);
  cfg.blockDim = dim3(chunk::kMergeThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, chunk::chunk_merge<D>, m);
}

// At CB > 1 the chunk tile; over an int8 pool at D 256 the 64-row tile,
// unsplit.
template <typename KV, int D>
cudaError_t launch_chunk(const ArgsI8& a, cudaStream_t stream) {
  if constexpr (!kChunkTile<KV, D>) {  // the 64-row tile, unsplit
    if (a.ks == nullptr || a.vs == nullptr || a.CB < 2 || a.qlen == nullptr)
      return cudaErrorInvalidValue;
    constexpr size_t smem = tile::SmemI8<D>::bytes;
    auto kern = paged_mma<KV, D, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int tiles = (a.CB * (a.Hq / a.Hkv) + tile::kRows - 1) / tile::kRows;
    kern<<<dim3(a.B, a.Hkv, tiles), tile::kThreads, smem, stream>>>(
        static_cast<const ArgsOf<KV>&>(a));
    return cudaGetLastError();
  } else {
    return launch_chunk_tile<KV, D>(a, stream);
  }
}

template <typename KV, bool kDecode>
cudaError_t dispatch_mma(int D, const ArgsI8& a, cudaStream_t s) {
  auto go = [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if constexpr (kDecode) {
      return launch_decode_mma<KV, kD>(a, s);
    } else {
      return launch_chunk<KV, kD>(a, s);
    }
  };
  switch (D) {
    case 64: return go(std::integral_constant<int, 64>{});
    case 128: return go(std::integral_constant<int, 128>{});
    case 256: return go(std::integral_constant<int, 256>{});
    default: return cudaErrorInvalidValue;
  }
}

// -- bf16 queries and pool at CB == 1 and GQA head groups: the group tile --

// group_tile.cuh's Source for one block of paged_group: query heads hk*G +
// f0 .. + R - 1 of row b (flat row r is head f0 + r, all at position qp)
// against split s's slots [t_lo, t_hi) of the row's logical view, t_hi
// at most its occupied slots min(n_blocks, n_cols) * bs: slot t's rows
// are those of table column t / bs (sentinels clamped to block N - 1),
// read in place at layer `layer` of the stacked pool, the table entry
// read where the copy is issued. A slot is visible at position p when 0
// <= p <= qp, inside the window when one is set, and it is not pending
// (its ring distance from slot0 is at least q_len); each row folds the
// one fresh key, its score and V in fp32.
template <int D>
struct PagedGroupSrc {
  using T = __nv_bfloat16;
  const T *q, *kc, *vc, *kn, *vn;
  T* o;
  const int *kvp, *bt;  // row b's positions and table
  int nr, t_lo, t_hi, ahead, S, split, n_fresh;
  int qp, ql, sl0, ring, window, bs, last_blk;
  long long base, blk_stride, slot_stride;  // layer `layer`'s block 0 of head hk
  long long h0, kv0;  // b * Hq + hk * G + f0; row b's fresh K/V row of head hk
  float scale_log2;
  float* ws;
  long long n_part, row0;

  __device__ const T* q_row(int r) const { return r < nr ? q + (h0 + r) * D : nullptr; }
  __device__ T* o_row(int r) const { return o + (h0 + r) * D; }
  __device__ int last_fresh(int) const { return 0; }
  __device__ const T* fresh_k(int) const { return kn + kv0; }
  __device__ const T* fresh_v(int) const { return vn + kv0; }
  __device__ bool vis(int t, int p) const {
    int d = t - sl0;
    if (d < 0) d += ring;
    return d >= ql && p >= 0 && p <= qp && (window <= 0 || p > qp - window);
  }
  __device__ long long kv_off(int t) const {
    const int blk = min(__ldg(bt + t / bs), last_blk);
    return base + blk * blk_stride + (long long)(t % bs) * slot_stride;
  }
};

// One block per (KV head hk and its row group of R = 16 * RW query heads,
// row b, split s of S) at CB == 1 (K3, and an all-decode K4, which takes
// the same plan and grid): the block's state goes to split_merge.cuh's
// workspace. A row with no live query (K4's padding, q_len 0) gets zeros
// from split_merge.
template <int D, int RW>
__global__ void __launch_bounds__(wt::Smem<D, RW>::NW * 32) paged_group(Args a) {
  using T = __nv_bfloat16;
  constexpr int R = wt::Smem<D, RW>::R;
  extern __shared__ __align__(16) unsigned char gsmem[];
  PagedGroupSrc<D> s;
  s.split = blockIdx.z;
  const int b = blockIdx.y, G = a.Hq / a.Hkv, ng = (G + R - 1) / R;
  const int hk = blockIdx.x / ng, f0 = (blockIdx.x % ng) * R;
  s.nr = min(R, G - f0);
  s.h0 = (long long)b * a.Hq + hk * G + f0;
  s.o = static_cast<T*>(a.o);
  s.ql = a.qlen ? a.qlen[b] : 1;
  if (s.ql < 1) return;
  const int t_end = min(max(a.nblk[b], 0), a.n_cols) * a.bs;
  s.t_lo = s.split * a.split;
  s.t_hi = min(t_end, s.t_lo + a.split);
  s.S = a.S;
  s.n_fresh = 1;
  s.q = static_cast<const T*>(a.q);
  s.kc = static_cast<const T*>(a.kp);
  s.vc = static_cast<const T*>(a.vp);
  s.kn = static_cast<const T*>(a.kn);
  s.vn = static_cast<const T*>(a.vn);
  s.ring = a.MB * a.bs;
  s.kvp = a.kvpos + (long long)b * s.ring;
  s.bt = a.tables + (long long)b * a.MB;
  s.qp = a.qpos[b];
  s.sl0 = a.slot0[b];
  s.window = a.window;
  s.bs = a.bs;
  s.last_blk = a.Np - 2;  // N - 1: block N is the write drop target
  s.slot_stride = (long long)a.Hkv * D;
  s.blk_stride = (long long)a.bs * s.slot_stride;
  s.base = (long long)a.layer * a.Np * s.blk_stride + (long long)hk * D;
  // Below a ring's wrap logical slot t holds position t, so the slots a
  // row can see are below q_pos + 1; past the wrap every slot is.
  s.ahead = min(s.qp + 1, s.t_hi) - s.t_lo;
  s.kv0 = ((long long)b * a.Hkv + hk) * D;
  s.scale_log2 = a.scale * 1.4426950408889634f;
  s.ws = a.ws;
  s.n_part = (long long)a.B * a.Hq * a.S;
  s.row0 = s.h0 * a.S + s.split;
  wt::run<D, RW, wt::kWorkspace>(s, gsmem);
}

// paged_group in S splits of `split` slots (whole 64-slot tiles and table
// columns covering the read), then split_merge on the same stream.
template <int D, int RW>
cudaError_t launch_group(const Args& a, cudaStream_t stream) {
  using SM = wt::Smem<D, RW>;
  if (a.CB != 1 || a.S < 1 || a.S > kMaxSplits || a.split <= 0 ||
      a.split % wt::kSlots || a.split % a.bs ||
      (long long)a.S * a.split < (long long)a.n_cols * a.bs || a.ws == nullptr)
    return cudaErrorInvalidValue;
  auto kern = paged_group<D, RW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SM::bytes);
  if (err != cudaSuccess) return err;
  const int groups = (a.Hq / a.Hkv + SM::R - 1) / SM::R;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Hkv * groups, a.B, a.S);
  cfg.blockDim = dim3(SM::NW * 32);
  cfg.dynamicSmemBytes = SM::bytes;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  const MergeArgs m{a.q, a.kn, a.vn, a.o, a.ws, a.nblk, a.qlen, a.B, a.Hq,
                    a.Hkv, a.S, a.split, a.bs, a.n_cols, a.scale};
  return launch_merge<__nv_bfloat16>(D, m, stream);
}

template <int D>
cudaError_t dispatch_group_rows(int rows, const Args& a, cudaStream_t s) {
  switch (rows) {
    case 16: return launch_group<D, 1>(a, s);
    case 32: return launch_group<D, 2>(a, s);
    case 48: return launch_group<D, 3>(a, s);
    case 64: return launch_group<D, 4>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_group(int D, int rows, const Args& a, cudaStream_t s) {
  switch (D) {
    case 64: return dispatch_group_rows<64>(rows, a, s);
    case 128: return dispatch_group_rows<128>(rows, a, s);
    case 256: return dispatch_group_rows<256>(rows, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace llmss

// q [B,CB,Hq,D], pools [L,Np,bs,Hkv,D] (block Np-1 is the write drop
// target; table entries are clamped to Np-2), k_new / v_new [B,CB,Hkv,D],
// out [B,CB,Hq,D], all contiguous and 16-byte aligned; q_pos / q_len /
// n_blocks / slot0 [B], kv_pos [B,MB*bs] and tables [B,MB] int32. q_len
// null means every row has one live query (K3). impl: 0 = paged_fwd with R
// (1, 2, 4 or 8) query rows per block, for fp32, CB == 1 or an int8 pool
// under fp32 queries, in S splits of `split` slots (S > 1 only at CB == 1,
// with ws the fp32 workspace of split_merge.cuh, [B*Hq*S*(D+2)]; null at
// S = 1); 1 = paged_mma over a bf16 pool and 2 = paged_mma over an int8
// pool, for bf16 queries: at CB > 1 the chunk tile, q_len required, in S
// splits of `split` slots (multiples of 64 and bs), ws chunk_tile.cuh's
// workspace [B*CB*Hq*S*(D+2)] at S > 1 (null at S = 1), R unused (over
// int8 at D 256 the 64-row tile, S and split unused); at CB ==
// 1 in S splits of `split` slots (a multiple of 64) with ws required at
// every S (R unused); 3 = paged_group over a bf16 pool
// for bf16 queries at CB == 1, R (16, 32, 48 or 64) query heads a block,
// S splits of `split` slots (multiples of 64 and bs), its states stored
// in ws and split_merge after. kv_dtype: the pool's dtype, dtype's
// own, or kI8 under fp32 or bf16 queries, with k_scale / v_scale
// [L,Np,bs,Hkv] fp32 (null otherwise).
// window <= 0 means full causal. Returns cudaGetLastError() after the last
// launch.
extern "C" int llmss_paged_attention(
    void* q, void* kp, void* vp, void* kn, void* vn, void* o, void* qpos,
    void* qlen, void* kvpos, void* tables, void* nblk, void* slot0, void* ws,
    int layer, int B, int CB, int Np, int bs, int MB, int n_cols, int Hq,
    int Hkv, int D, int R, int S, int split, int dtype, int impl, float scale,
    int window, void* stream, void* k_scale, void* v_scale, int kv_dtype) {
  using namespace llmss;
  if (B == 0) return 0;
  const ArgsI8 a{{q, kp, vp, kn, vn, o,
                 static_cast<const int*>(qpos), static_cast<const int*>(qlen),
                 static_cast<const int*>(kvpos), static_cast<const int*>(tables),
                 static_cast<const int*>(nblk), static_cast<const int*>(slot0),
                 layer, B, CB, Np, bs, MB, n_cols, Hq, Hkv, scale, window,
                 static_cast<float*>(ws), S, split},
                static_cast<const float*>(k_scale),
                static_cast<const float*>(v_scale)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tile16 = dtype == kBF16 && kv_dtype == kBF16;
  const bool tile8 = dtype == kBF16 && kv_dtype == kI8;
  cudaError_t err = cudaErrorInvalidValue;
  if (impl == 1 && tile16 && CB > 1 && qlen != nullptr) {
    err = dispatch_mma<__nv_bfloat16, false>(D, a, s);
  } else if (impl == 1 && tile16 && CB == 1) {
    err = dispatch_mma<__nv_bfloat16, true>(D, a, s);
  } else if (impl == 2 && tile8 && CB > 1 && qlen != nullptr) {
    err = dispatch_mma<int8_t, false>(D, a, s);
  } else if (impl == 2 && tile8 && CB == 1) {
    err = dispatch_mma<int8_t, true>(D, a, s);
  } else if (impl == 3 && tile16 && CB == 1) {
    err = dispatch_group(D, R, a, s);
  } else if (impl == 0 && !((tile16 || tile8) && CB > 1)) {
    if (dtype == kF32 && kv_dtype == kF32) err = dispatch_d<float, float>(D, R, a, s);
    if (dtype == kBF16 && kv_dtype == kBF16)
      err = dispatch_d<__nv_bfloat16, __nv_bfloat16>(D, R, a, s);
    if (dtype == kF32 && kv_dtype == kI8) err = dispatch_d<float, int8_t>(D, R, a, s);
    if (dtype == kBF16 && kv_dtype == kI8)
      err = dispatch_d<__nv_bfloat16, int8_t>(D, R, a, s);
  }
  return static_cast<int>(err);
}
