// K2w: the decode window's deferred-write attention over the layer-stacked
// KV cache (the speculative verify forward, S = gamma + 1 <= 8 tokens a
// row).
//
// Replaces no Pallas kernel: the reference runs this window through its
// XLA oracle fresh_kv_window_attention (llmss_tpu/ops/attention.py:186,
// mask window_mask_penalty :166). Same function: for each row b, window
// query i and query head h, one exact softmax over
//   * the slots t < t_len of layer `layer` of the STALE cache
//     [L, B, T, Hkv, D] (the window not yet written) whose position p
//     satisfies 0 <= p < q_pos0[b] (every cache slot before the window is
//     visible to all its queries) and which are not among the window's S
//     pending slots, the ring range slot0[b], slot0[b] + 1, ... (mod T),
//     which on a ring wrap hold tokens the window overwrites; and
//   * the window's own fresh keys j <= i (k_new / v_new [B, S, Hkv, D]),
// query head h reading KV head h / G. Scores, running max / sum and
// accumulators are fp32; the cache's P is rounded to the value dtype
// before P.V, as K2 does; the fresh keys' scores and V stay fp32.
//
// What bounds it on the H100: memory, as K2. A window reads each KV head's
// t_len * D keys and values for G * S query rows, ~4 flops per element
// and row, far below the ~295 flops per byte where the tensor cores would
// become the limit. So every block reads its KV head's slots once for a
// group of its G * S window rows, and the design is about keeping bytes in
// flight with as little per-block work as possible:
//   * Window row f (0 <= f < G * S) of KV head hk is query f / G under
//     query head hk * G + f % G, read in place from q [B, S, Hq, D]: no
//     transpose of the queries.
//   * bf16 queries: window_mma, the group tile of group_tile.cuh (the
//     tile K2 and K3 take at GQA head groups). Its rows per block follow
//     G * S (16 a warp: 16 for MHA's 2 to 8, 32 for G 4, 48 for
//     Qwen2's 35, 64 for StarCoder's 240 in four groups), so at
//     Llama-2-7B's verify shape 11 of 16 mma rows are dead where the
//     shared 64-row tile of attn_tile.cuh had 59 of 64; Q stays in
//     registers, which leaves room for a three-stage ring at two blocks an
//     SM; a block's first tiles are copied before their positions are
//     read; and the splits of a read, where the plan splits it (a grid
//     that leaves SMs idle), are one thread block cluster that folds them
//     in the kernel, so there is no second launch and no workspace. On
//     the H100 a block's fixed chain of latencies, more than its bytes,
//     sets the time at the verify shape: the plan keeps the grid to one
//     round of resident blocks where it can (ops/decode_attention.py).
//   * fp32 / fp16 queries: window_fwd, K2's lane template (8 warps;
//     cp.async rings of K/V rows in shared memory, csrc/split_merge.cuh
//     LaneRing) with GB rows a block, the last group of a KV head partial
//     where GB does not divide G * S. It stores each row's fp32 (m, l, acc) in split_merge.cuh's
//     workspace, indexed by window row: [B, Hkv, G * S] rows of [S_split]
//     states; window_merge, a programmatic dependent launch on the same
//     stream, computes the fresh keys' scores before it waits, then folds
//     the splits in split order and the fresh keys j <= i in order, and
//     writes the output in q's layout.
// The cache mask is query-invariant (p < q_pos0 for every window query),
// so it is applied once per slot when the positions are staged, exactly
// as K2 applies its own.

#include "attn_tile.cuh"
#include "common.cuh"
#include "group_tile.cuh"
#include "split_merge.cuh"

namespace llmss {
namespace {

constexpr int NWARP = 8;
constexpr int NT = NWARP * 32;
using wt::kMaxWin;  // ops/decode_attention.py WINDOW_MAX

struct WinArgs {
  const void* q;   // [B, Sw, Hq, D]
  const void* kc;  // [L, B, T, Hkv, D]
  const void* vc;
  const void* kn;  // [B, Sw, Hkv, D]
  const void* vn;
  void* o;           // [B, Sw, Hq, D]
  const int* qpos;   // [B] position of each row's first window query
  const int* kvpos;  // [B, T]
  const int* slot0;  // [B] ring slot of each row's first window token
  float* ws;         // split partials, [B, Hkv, G * Sw] rows of S states
  int layer, B, Tn, t_len, Hq, Hkv, Sw, S, split;
  float scale;
};

// Whether ring slot t is one of the window's pending slots.
__device__ __forceinline__ bool pending(int t, int slot0, int Sw, int Tn) {
  int d = t - slot0;
  if (d < 0) d += Tn;
  return d < Sw;
}

template <typename T, int D, int GB>
struct Cfg {
  static constexpr int LPS = D / 8;          // lanes per slot (8 elements each)
  static constexpr int SPW = 32 / LPS;       // slots per warp per step
  static constexpr int STEP = NWARP * SPW;   // slots per step of the block
  static constexpr int SLOTS = STEP * kSteps;  // slots per ring stage
  // The warps' K/V rings, reused by s_acc [NWARP][GB][D] once the KV loop
  // is done | s_m, s_l [NWARP][GB] | staged positions
  static constexpr size_t ring = size_t(NWARP) * LaneRing<T>::WARP_BYTES;
  static constexpr size_t acc = sizeof(float) * NWARP * GB * D;
  static constexpr size_t region = ring > acc ? ring : acc;
  static constexpr size_t smem = region + sizeof(float) * 2 * NWARP * GB + sizeof(int) * kStage;
};

// One block per (row b, KV head hk, group of GB window rows, split s of S
// along the slots); stores each window row's fp32 state of slots
// [s * split, (s + 1) * split) of [0, t_len). kPart: GB does not divide
// G * Sw, so each KV head's last group is partial.
template <typename T, int D, int GB, bool kPart>
__global__ void __launch_bounds__(NT, kLaneMinBlocks<T, GB>) window_fwd(WinArgs a) {
  using C = Cfg<T, D, GB>;
  using Ring = LaneRing<T>;
  constexpr int LPS = C::LPS, SPW = C::SPW;
  extern __shared__ __align__(16) float smem[];
  float* s_acc = smem;                            // [NWARP][GB][D], after the KV loop
  float* s_m = smem + C::region / sizeof(float);  // [NWARP][GB]
  float* s_l = s_m + NWARP * GB;                  // [NWARP][GB]
  int* s_pos = reinterpret_cast<int*>(s_l + NWARP * GB);  // [kStage]

  pdl_trigger();  // window_merge may start; it waits for this grid's writes

  const T* q = static_cast<const T*>(a.q);
  const T* kc = static_cast<const T*>(a.kc);
  const T* vc = static_cast<const T*>(a.vc);

  const int b = blockIdx.x;
  const int G = a.Hq / a.Hkv;
  const int Gv = G * a.Sw;  // window rows per KV head
  const int ng = kPart ? (Gv + GB - 1) / GB : Gv / GB;
  const int hk = blockIdx.y / ng;
  const int f0 = (blockIdx.y % ng) * GB;
  const int gn = kPart ? min(GB, Gv - f0) : GB;  // live rows: g < gn
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPS, part = lane % LPS;
  const int e0 = part * 8;  // this lane's 8 features
  const int split = blockIdx.z;
  const int t_lo = split * a.split;
  const int t_hi = min(a.t_len, t_lo + a.split);

  const long long row_stride = (long long)a.Hkv * D;
  const long long base =
      ((long long)a.layer * a.B + b) * (long long)a.Tn * row_stride + hk * D + e0;
  const int* kvp = a.kvpos + (long long)b * a.Tn;

  // Every load the KV loop needs first is issued here, before any is used.
  constexpr int PPT = kStage / NT;
  int pv[PPT];
  auto load_window = [&](int w0, int w1) {
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int t = w0 + j * NT + threadIdx.x;
      pv[j] = t < w1 ? kvp[t] : -1;
    }
  };
  const int q0 = a.qpos[b];
  const int slot0 = a.slot0[b];
  Vec8<T> qv[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g < gn) {
      const int f = f0 + g;  // query f / G under head hk * G + f % G
      qv[g].load(q + (((long long)b * a.Sw + f / G) * a.Hq + hk * G + f % G) * D + e0);
    }
  }
  if (t_lo < t_hi) load_window(t_lo, min(t_hi, t_lo + kStage));

  float qf[GB][8];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    if (g < gn) {
      qv[g].to_float(qf[g]);
    } else {  // a dead row: computed, never stored
#pragma unroll
      for (int e = 0; e < 8; ++e) qf[g][e] = 0.f;
    }
  }

  float m[GB], l[GB], acc[GB][8];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }
  char* wring = reinterpret_cast<char*>(smem) + warp * Ring::WARP_BYTES;

  // Fold one step's slots into each row's running softmax; ok[u]: slot u
  // is visible.
  auto step = [&](const Vec8<T>(&kv)[kSteps], const Vec8<T>(&vv)[kSteps],
                  const bool(&ok)[kSteps]) {
    float s[kSteps][GB];
#pragma unroll
    for (int u = 0; u < kSteps; ++u) {
      float kf[8];
      if (ok[u]) kv[u].to_float(kf);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float d = 0.f;
        if (ok[u]) {
#pragma unroll
          for (int e = 0; e < 8; ++e) d = fmaf(qf[g][e], kf[e], d);
        }
#pragma unroll
        for (int off = LPS / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        s[u][g] = ok[u] ? d * a.scale : kNegInf;
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) m_new = fmaxf(m_new, s[u][g]);
      if (m_new == kNegInf) continue;  // nothing visible yet in this stream
      const float alpha = expf(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (!ok[u]) continue;  // masked slots contribute exactly 0
        const float p = expf(s[u][g] - m_new);
        l[g] += p;
        const float pr = round_to<T>(p);
        float vf[8];
        vv[u].to_float(vf);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pr, vf[e], acc[g][e]);
      }
      m[g] = m_new;
    }
  };

  for (int w0 = t_lo; w0 < t_hi; w0 += kStage) {
    const int w1 = min(t_hi, w0 + kStage);
    if (w0 != t_lo) load_window(w0, w1);
    __syncthreads();  // the previous window's staged slots are consumed
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int i = j * NT + threadIdx.x, t = w0 + i, p = pv[j];
      s_pos[i] = p >= 0 && p < q0 && !pending(t, slot0, a.Sw, a.Tn) ? p : -1;
    }
    __syncthreads();

    // Ring stage i holds the window's slots [i * SLOTS, (i + 1) * SLOTS):
    // slot w0 + (i * kSteps + u) * STEP + warp * SPW + sub for this lane.
    const int n_st = (w1 - w0 + C::SLOTS - 1) / C::SLOTS;
    auto slot_of = [&](int i, int u) { return w0 + (i * kSteps + u) * C::STEP + warp * SPW + sub; };
    auto issue = [&](int i) {
      if (i < n_st) {
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          const int t = slot_of(i, u);
          if (t < w1 && s_pos[t - w0] >= 0) {
            const long long off = base + (long long)t * row_stride;
            Ring::put(wring, i % Ring::STAGES, u, lane, kc + off, vc + off);
          }
        }
      }
      tile::cp_async_commit();  // empty past the window: keeps the count
    };
#pragma unroll
    for (int i = 0; i < Ring::STAGES - 1; ++i) issue(i);
    for (int i = 0; i < n_st; ++i) {
      issue(i + Ring::STAGES - 1);
      tile::cp_async_wait<Ring::STAGES - 1>();  // this lane's stage i landed
      Vec8<T> kv[kSteps], vv[kSteps];
      bool ok[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int t = slot_of(i, u);
        ok[u] = t < w1 && s_pos[t - w0] >= 0;
        if (ok[u]) {
          ring_get(kv[u], wring, i % Ring::STAGES, u, 0, lane);
          ring_get(vv[u], wring, i % Ring::STAGES, u, 1, lane);
        }
      }
      bool any = false;
#pragma unroll
      for (int u = 0; u < kSteps; ++u) any |= ok[u];
      // A step no lane of the warp sees leaves the state as it is.
      if (__any_sync(0xffffffffu, any)) step(kv, vv, ok);
    }
  }

  // Merge the SPW slot streams of this warp (lanes differing in `sub`).
#pragma unroll
  for (int off = LPS; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mm = fmaxf(m[g], m_o);
      const float x = expf(m[g] - mm), y = expf(m_o - mm);
      l[g] = l[g] * x + l_o * y;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * x + acc_o * y;
      }
      m[g] = mm;
    }
  }
  __syncthreads();  // every warp is done with its ring: s_acc reuses it
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        s_acc[(warp * GB + g) * D + e0 + e] = acc[g][e];
      if (part == 0) {
        s_m[warp * GB + g] = m[g];
        s_l[warp * GB + g] = l[g];
      }
    }
  }
  __syncthreads();
  store_partial<NWARP, D, GB>(s_acc, s_m, s_l, a.ws, a.B, a.Hq * a.Sw, a.S, b, split,
                              [&](int g) { return g < gn ? hk * Gv + f0 + g : -1; });
}

// window_mma: the window tile, group_tile.cuh's tile over the window's G
// * Sw rows of KV head hk (flat row r is window row f0 + r: query (f0 +
// r) / G under query head hk * G + (f0 + r) % G), a split's slots [t_lo,
// t_hi) of layer `layer` of the stale cache read in place; a slot is
// visible at position p, 0 <= p < q_pos0, outside the pending ring range,
// and row r folds the window's fresh keys j <= (f0 + r) / G. kCluster: the
// splits fold in their cluster and write the output; otherwise the block
// stores its state in split_merge.cuh's workspace and window_merge
// follows (the two-launch form, kept to time against).
template <int D>
struct WinSrc {
  using T = __nv_bfloat16;
  const T *q, *kc, *vc, *kn, *vn;
  T* o;
  const int* kvp;  // row b's positions
  int nr, t_lo, t_hi, ahead, S, split, n_fresh;
  int b, hk, G, f0, Sw, Hq, Hkv, q0, slot0, Tn;
  long long base, row_stride;  // slot 0's K/V row of head hk; Hkv * D
  float scale_log2;
  float* ws;
  long long n_part, row0;

  __device__ long long q_off(int r) const {
    const int f = f0 + r;
    return (((long long)b * Sw + f / G) * Hq + hk * G + f % G) * D;
  }
  __device__ const T* q_row(int r) const { return r < nr ? q + q_off(r) : nullptr; }
  __device__ T* o_row(int r) const { return o + q_off(r); }
  __device__ int last_fresh(int r) const { return (f0 + r) / G; }
  __device__ const T* fresh_k(int j) const { return kn + (((long long)b * Sw + j) * Hkv + hk) * D; }
  __device__ const T* fresh_v(int j) const { return vn + (((long long)b * Sw + j) * Hkv + hk) * D; }
  __device__ bool vis(int t, int p) const { return p >= 0 && p < q0 && !pending(t, slot0, Sw, Tn); }
  __device__ long long kv_off(int t) const { return base + (long long)t * row_stride; }
};

template <int D, int RW, bool kCluster>
__global__ void __launch_bounds__(wt::Smem<D, RW>::NW * 32) window_mma(WinArgs a) {
  constexpr int R = wt::Smem<D, RW>::R;
  extern __shared__ __align__(16) unsigned char wsmem[];
  WinSrc<D> s;
  s.split = blockIdx.z;
  s.b = blockIdx.y;
  s.G = a.Hq / a.Hkv;
  const int Gv = s.G * a.Sw;
  const int ng = (Gv + R - 1) / R;
  s.hk = blockIdx.x / ng;
  s.f0 = (blockIdx.x % ng) * R;
  s.nr = min(R, Gv - s.f0);
  s.t_lo = s.split * a.split;
  s.t_hi = min(a.t_len, s.t_lo + a.split);
  s.S = a.S;
  s.Sw = s.n_fresh = a.Sw;
  s.Hq = a.Hq;
  s.Hkv = a.Hkv;
  s.Tn = a.Tn;
  s.q = static_cast<const __nv_bfloat16*>(a.q);
  s.kc = static_cast<const __nv_bfloat16*>(a.kc);
  s.vc = static_cast<const __nv_bfloat16*>(a.vc);
  s.kn = static_cast<const __nv_bfloat16*>(a.kn);
  s.vn = static_cast<const __nv_bfloat16*>(a.vn);
  s.o = static_cast<__nv_bfloat16*>(a.o);
  s.row_stride = (long long)a.Hkv * D;
  s.base = ((long long)a.layer * a.B + s.b) * (long long)a.Tn * s.row_stride +
           (long long)s.hk * D;
  s.kvp = a.kvpos + (long long)s.b * a.Tn;
  s.q0 = a.qpos[s.b];
  s.slot0 = a.slot0[s.b];
  // Below a ring's wrap slot t holds position t, so a tile from slot
  // q_pos0 up is hidden and left to the mask; past the wrap every slot is
  // below q_pos0.
  s.ahead = min(s.q0, s.t_hi) - s.t_lo;
  s.scale_log2 = a.scale * 1.4426950408889634f;
  // split_merge.cuh's workspace, indexed by window row: state row
  // (b * Hq * Sw + hk * Gv + f0 + r) * S + split.
  const long long hq = (long long)a.Hq * a.Sw;
  s.ws = a.ws;
  s.n_part = (long long)a.B * hq * a.S;
  s.row0 = (s.b * hq + (long long)s.hk * Gv + s.f0) * a.S + s.split;
  wt::run<D, RW, kCluster ? wt::kCluster : wt::kWorkspace>(s, wsmem);
}

struct WinMergeArgs {
  const void* q;  // [B, Sw, Hq, D]
  const void* kn;  // [B, Sw, Hkv, D]
  const void* vn;
  void* o;  // [B, Sw, Hq, D]
  const float* ws;
  int B, Hq, Hkv, Sw, S;
  float scale;
};

// One block of D threads per (row b, window query i, query head h); thread
// d owns feature d. Folds the splits' states of window row i * G + g of KV
// head h / G in split order, then the fresh keys j <= i in order.
template <typename T, int D>
__global__ void __launch_bounds__(D) window_merge(WinMergeArgs a) {
  __shared__ float red[kMaxWin][D / 32];
  const int b = blockIdx.x, i = blockIdx.y / a.Hq, h = blockIdx.y % a.Hq;
  const int d = threadIdx.x;
  const int G = a.Hq / a.Hkv, hk = h / G, g = h % G;
  const long long qrow = ((long long)b * a.Sw + i) * a.Hq + h;
  const float qd = to_f<T>(static_cast<const T*>(a.q)[qrow * D + d]);
  const T* kn = static_cast<const T*>(a.kn);
  const T* vn = static_cast<const T*>(a.vn);
  // Before the wait, only what the split kernel does not write: the fresh
  // keys' scores.
#pragma unroll
  for (int j = 0; j < kMaxWin; ++j) {
    if (j > i) break;
    float x = qd * to_f<T>(kn[(((long long)b * a.Sw + j) * a.Hkv + hk) * D + d]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    if (d % 32 == 0) red[j][d / 32] = x;
  }
  __syncthreads();
  float sn[kMaxWin];
#pragma unroll
  for (int j = 0; j < kMaxWin; ++j) {
    sn[j] = kNegInf;
    if (j <= i) {
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < D / 32; ++w) x += red[j][w];
      sn[j] = x * a.scale;
    }
  }

  pdl_wait();  // the split kernel's partials are complete and visible
  const long long hq = (long long)a.Hq * a.Sw;
  const long long n_part = (long long)a.B * hq * a.S;
  const long long row0 = ((long long)b * hq + (long long)hk * G * a.Sw + i * G + g) * a.S;
  const float* acc = a.ws + row0 * D + d;
  const float* m = a.ws + n_part * D + row0;
  const float* l = m + n_part;
  float mv[kMaxSplits], lv[kMaxSplits], av[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s < a.S) {
      mv[s] = m[s];
      lv[s] = l[s];
      av[s] = acc[(long long)s * D];
    }
  }
  float M = kNegInf;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    if (s < a.S) M = fmaxf(M, mv[s]);
#pragma unroll
  for (int j = 0; j < kMaxWin; ++j) M = fmaxf(M, sn[j]);  // key 0: finite
  float den = 0.f, O = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s < a.S) {
      const float sc = mv[s] == kNegInf ? 0.f : expf(mv[s] - M);
      den += lv[s] * sc;
      O += av[s] * sc;
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxWin; ++j) {  // the fresh keys, folded last
    if (j <= i) {
      const float pn = expf(sn[j] - M);
      den += pn;
      O += pn * to_f<T>(vn[(((long long)b * a.Sw + j) * a.Hkv + hk) * D + d]);
    }
  }
  static_cast<T*>(a.o)[qrow * D + d] = from_f<T>(O / den);
}

template <typename T, int D>
cudaError_t launch_window_merge(const WinMergeArgs& m, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(m.B, m.Sw * m.Hq);
  cfg.blockDim = dim3(D);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, window_merge<T, D>, m);
}

template <typename T, int D>
cudaError_t merge_after(const WinArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const WinMergeArgs m{a.q, a.kn, a.vn, a.o, a.ws, a.B, a.Hq, a.Hkv, a.Sw, a.S, a.scale};
  return launch_window_merge<T, D>(m, stream);
}

bool bad_split(const WinArgs& a, int unit) {
  return a.S < 1 || a.S > kMaxSplits || a.split <= 0 || a.split % unit ||
         (long long)a.S * a.split < a.t_len || a.Sw < 2 || a.Sw > kMaxWin;
}

// window_fwd in S splits of `split` slots (whole ring stages covering
// [0, t_len)), then window_merge on the same stream.
template <typename T, int D, int GB>
cudaError_t launch(const WinArgs& a, cudaStream_t stream) {
  if (bad_split(a, Cfg<T, D, GB>::SLOTS)) return cudaErrorInvalidValue;
  constexpr size_t smem = Cfg<T, D, GB>::smem;
  const int Gv = a.Hq / a.Hkv * a.Sw;
  auto kern = window_fwd<T, D, GB, false>;
  if (Gv % GB) {  // partial groups: GB is 4 or 8
    if constexpr (GB >= 4) {
      kern = window_fwd<T, D, GB, true>;
    } else {
      return cudaErrorInvalidValue;
    }
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B, a.Hkv * ((Gv + GB - 1) / GB), a.S);
  kern<<<grid, NT, smem, stream>>>(a);
  return merge_after<T, D>(a, stream);
}

// fp32 / fp16 windows (bf16 ones take window_mma).
template <typename T, int D>
cudaError_t dispatch_g(int GB, const WinArgs& a, cudaStream_t s) {
  switch (GB) {
    case 2: return launch<T, D, 2>(a, s);
    case 4: return launch<T, D, 4>(a, s);
    case 8: return launch<T, D, 8>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_d(int D, int GB, const WinArgs& a, cudaStream_t s) {
  switch (D) {
    case 64: return dispatch_g<T, 64>(GB, a, s);
    case 128: return dispatch_g<T, 128>(GB, a, s);
    case 256: return dispatch_g<T, 256>(GB, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// window_mma over S splits of `split` slots (whole 64-slot tiles), R =
// 16 * RW window rows a block. kCluster: the splits of one (row, KV head,
// row group) are one cluster of S <= 8 blocks, which writes the output;
// otherwise window_merge follows on the same stream.
template <int D, int RW, bool kCluster>
cudaError_t launch_mma(const WinArgs& a, cudaStream_t stream) {
  using SM = wt::Smem<D, RW>;
  if (bad_split(a, wt::kSlots) || (kCluster && a.S > wt::kMaxCluster) ||
      (!kCluster && a.ws == nullptr))
    return cudaErrorInvalidValue;
  auto kern = window_mma<D, RW, kCluster>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SM::bytes);
  if (err != cudaSuccess) return err;
  const int groups = (a.Hq / a.Hkv * a.Sw + SM::R - 1) / SM::R;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.Hkv * groups, a.B, a.S);
  cfg.blockDim = dim3(SM::NW * 32);
  cfg.dynamicSmemBytes = SM::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if (kCluster && a.S > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = a.S;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  if constexpr (kCluster) {
    return cudaGetLastError();
  } else {
    return merge_after<__nv_bfloat16, D>(a, stream);
  }
}

template <int D, bool kCluster>
cudaError_t dispatch_rows(int rows, const WinArgs& a, cudaStream_t s) {
  switch (rows) {
    case 16: return launch_mma<D, 1, kCluster>(a, s);
    case 32: return launch_mma<D, 2, kCluster>(a, s);
    case 48: return launch_mma<D, 3, kCluster>(a, s);
    case 64: return launch_mma<D, 4, kCluster>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kCluster>
cudaError_t dispatch_mma(int D, int rows, const WinArgs& a, cudaStream_t s) {
  switch (D) {
    case 64: return dispatch_rows<64, kCluster>(rows, a, s);
    case 128: return dispatch_rows<128, kCluster>(rows, a, s);
    case 256: return dispatch_rows<256, kCluster>(rows, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace llmss

// q [B,Sw,Hq,D], cache [L,B,T,Hkv,D], k_new / v_new [B,Sw,Hkv,D], out
// [B,Sw,Hq,D], all contiguous and of one dtype; q_pos0 / slot0 [B] and
// kv_pos [B,T] int32; 2 <= Sw <= 8. impl: 0 = window_fwd for fp32 / fp16
// with GB (2, 4 or 8) window rows per block (the last of a KV head's ceil(G*Sw / GB) groups
// may be partial), S splits of `split` slots (a multiple of the lane
// loop's step), then window_merge; 1 = window_mma for bf16 with GB (16,
// 32, 48 or 64) window rows per block, S <= 8 splits of `split` slots (a
// multiple of 64) as one cluster; 2 = the same at D 128 and 16 rows with
// the states stored and window_merge launched after (the two-launch form,
// timed beside the cluster form). ws: the fp32 workspace of split_merge.cuh
// for B*Hq*Sw rows, [B*Hq*Sw*S*(D+2)], at every S, for impl 0 and 2; null
// for 1. Returns cudaGetLastError() after the last launch.
extern "C" int llmss_window_attention(void* q, void* kc, void* vc, void* kn,
                                      void* vn, void* o, void* qpos,
                                      void* kvpos, void* slot0, void* ws,
                                      int layer, int B, int T, int t_len,
                                      int Hq, int Hkv, int D, int Sw, int GB,
                                      int S, int split, int dtype, int impl,
                                      float scale, void* stream) {
  using namespace llmss;
  if (B == 0) return 0;
  const WinArgs a{q, kc, vc, kn, vn, o,
                  static_cast<const int*>(qpos), static_cast<const int*>(kvpos),
                  static_cast<const int*>(slot0), static_cast<float*>(ws),
                  layer, B, T, t_len, Hq, Hkv, Sw, S, split, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (impl == 1) {
    if (dtype == kBF16) err = dispatch_mma<true>(D, GB, a, s);
  } else if (impl == 2) {
    if (dtype == kBF16) err = dispatch_mma<false>(D, GB, a, s);
  } else if (impl == 0) {
    if (a.ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == kF32) err = dispatch_d<float>(D, GB, a, s);
    if (dtype == kF16) err = dispatch_d<__half>(D, GB, a, s);
  }
  return static_cast<int>(err);
}
