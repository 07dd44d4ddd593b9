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
// become the limit. So the design is K2's (csrc/decode_attention.cu),
// with the G * S window rows of a KV head in the place of K2's G query
// heads: every block reads its KV head's slots once for all of them.
//   * Window row f (0 <= f < G * S) of KV head hk is query f / G under
//     query head hk * G + f % G, read in place from q [B, S, Hq, D]: no
//     transpose of the queries.
//   * G * S <= 2 (MHA at gamma 1), or fp32 / fp16 queries: window_fwd,
//     K2's lane template (8 warps; cp.async rings of K/V rows in shared
//     memory, csrc/split_merge.cuh LaneRing) with GB rows a block, the
//     last group of a KV head partial where GB does not divide G * S.
//     bf16 is built at GB = 2 only.
//   * bf16 queries with G * S > 2 (ops/decode_attention.py WINDOW_G_TILE;
//     Llama-2-7B at gamma 4: 5 rows, Qwen2's G 7, StarCoder's 48):
//     window_mma, the tensor-core tile of attn_tile.cuh with its 64 flat
//     rows the window rows of one KV head. On the H100 the lanes at 8
//     rows a block took 2.5x the tile's time at Llama-2-7B's verify shape
//     (PERF.md; why is not measured); chip_smoke.py times both at 2 rows.
//   * Both split the read along the KV axis (ops/split_plan.py) and always
//     store each row's fp32 (m, l, acc) in split_merge.cuh's workspace,
//     indexed by window row: [B, Hkv, G * S] rows of [S_split] states.
//     window_merge, a programmatic dependent launch on the same stream,
//     computes the fresh keys' scores before it waits, then folds the
//     splits in split order and the fresh keys j <= i in order, and
//     writes the output in q's layout.
// The cache mask is query-invariant (p < q_pos0 for every window query),
// so it is applied once per slot when the positions are staged (lanes) or
// read (tile), exactly as K2 applies its own.

#include "attn_tile.cuh"
#include "common.cuh"
#include "split_merge.cuh"

namespace llmss {
namespace {

constexpr int NWARP = 8;
constexpr int NT = NWARP * 32;
constexpr int kMaxWin = 8;  // ops/decode_attention.py WINDOW_MAX

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

// tile::attend's Source for one block of window_mma: window rows f0 ..
// f0 + 63 of KV head hk of row b (flat row r is window row f0 + r: query
// (f0 + r) / G under head hk * G + (f0 + r) % G, every one at position
// q_pos0 - 1 so that the tile's mask p <= q is the window's p < q_pos0)
// against split s's slots [t_lo, t_hi) of layer `layer`, addressed from
// t_lo: slot x is ring slot t_lo + x, hidden when it is empty, pending, or
// at or past t_hi.
template <int D>
struct WinSrc {
  using T = __nv_bfloat16;
  const T *q, *kc, *vc;
  const int* kvp;  // row b's positions from t_lo
  int f0, G, Gv, Hq, Sw, b, hk, qp, t_lo, slot0, Tn, t_end;
  long long base, row_stride;  // slot t_lo's K/V row of head hk; Hkv * D
  int n_tiles, qmax, qmin, window;
  float scale_log2;

  __device__ bool has(int r) const { return f0 + r < Gv; }
  __device__ const T* q_row(int r) const {
    if (!has(r)) return nullptr;
    const int f = f0 + r;
    return q + (((long long)b * Sw + f / G) * Hq + hk * G + f % G) * D;
  }
  __device__ int q_pos(int r) const { return has(r) ? qp : -1; }
  __device__ int slot_pos(int t, int j) const {
    const int x = t * tile::kSlots + j;
    return x < t_end && !pending(t_lo + x, slot0, Sw, Tn) ? kvp[x] : -1;
  }
  __device__ bool rows(int t, int j, const T*& kr, const T*& vr) const {
    const int x = t * tile::kSlots + j;
    if (x >= t_end) return false;
    const long long off = base + x * row_stride;
    kr = kc + off;
    vr = vc + off;
    return true;
  }
  __device__ const T* any_ptr() const { return q; }
};

// One block per (row b, KV head hk, 64 of its G * Sw window rows, split s
// of S) on the tensor-core tile; stores each window row's fp32 state.
template <int D>
__global__ void __launch_bounds__(tile::kThreads) window_mma(WinArgs a) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  pdl_trigger();  // window_merge may start; it waits for this grid's writes
  const int b = blockIdx.x, hk = blockIdx.y;
  const int G = a.Hq / a.Hkv, Gv = G * a.Sw;
  const int split = blockIdx.z % a.S, f0 = blockIdx.z / a.S * tile::kRows;
  const int t_lo = split * a.split, t_hi = min(a.t_len, t_lo + a.split);
  tile::WithPartial<WinSrc<D>> s;
  s.q = static_cast<const T*>(a.q);
  s.kc = static_cast<const T*>(a.kc);
  s.vc = static_cast<const T*>(a.vc);
  s.kvp = a.kvpos + (long long)b * a.Tn + t_lo;
  s.f0 = f0;
  s.G = G;
  s.Gv = Gv;
  s.Hq = a.Hq;
  s.Sw = a.Sw;
  s.b = b;
  s.hk = hk;
  s.qp = a.qpos[b] - 1;
  s.t_lo = t_lo;
  s.slot0 = a.slot0[b];
  s.Tn = a.Tn;
  s.t_end = t_hi - t_lo;
  s.row_stride = (long long)a.Hkv * D;
  s.base = (((long long)a.layer * a.B + b) * a.Tn + t_lo) * s.row_stride + (long long)hk * D;
  s.n_tiles = (s.t_end + tile::kSlots - 1) / tile::kSlots;
  s.qmax = s.qmin = s.qp;
  s.window = 0;
  s.scale_log2 = a.scale * 1.4426950408889634f;
  const long long hq = (long long)a.Hq * a.Sw;  // window rows of a batch row
  s.part = {a.ws, (long long)a.B * hq * a.S, (b * hq + (long long)hk * Gv + f0) * a.S + split,
            a.S, min(tile::kRows, Gv - f0)};
  tile::attend<T, D, true>(s, tile_smem);
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
         (long long)a.S * a.split < a.t_len || a.ws == nullptr || a.Sw < 2 ||
         a.Sw > kMaxWin;
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

// bf16 windows of more than WINDOW_G_TILE = 2 rows a KV head take
// window_mma, so bf16 has lanes at GB = 2 only.
template <typename T, int D>
cudaError_t dispatch_g(int GB, const WinArgs& a, cudaStream_t s) {
  constexpr bool kWide = !std::is_same_v<T, __nv_bfloat16>;
  if (GB == 2) return launch<T, D, 2>(a, s);
  if constexpr (kWide) {
    if (GB == 4) return launch<T, D, 4>(a, s);
    if (GB == 8) return launch<T, D, 8>(a, s);
  }
  return cudaErrorInvalidValue;
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

// window_mma in S splits of `split` slots (whole 64-slot tiles), then
// window_merge on the same stream.
template <int D>
cudaError_t launch_mma(const WinArgs& a, cudaStream_t stream) {
  if (bad_split(a, tile::kSlots)) return cudaErrorInvalidValue;
  constexpr size_t smem = tile::Smem<D>::bytes;
  auto kern = window_mma<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.Hq / a.Hkv * a.Sw + tile::kRows - 1) / tile::kRows;
  dim3 grid(a.B, a.Hkv, tiles * a.S);
  kern<<<grid, tile::kThreads, smem, stream>>>(a);
  return merge_after<__nv_bfloat16, D>(a, stream);
}

cudaError_t dispatch_mma(int D, const WinArgs& a, cudaStream_t s) {
  switch (D) {
    case 64: return launch_mma<64>(a, s);
    case 128: return launch_mma<128>(a, s);
    case 256: return launch_mma<256>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace llmss

// q [B,Sw,Hq,D], cache [L,B,T,Hkv,D], k_new / v_new [B,Sw,Hkv,D], out
// [B,Sw,Hq,D], all contiguous and of one dtype; q_pos0 / slot0 [B] and
// kv_pos [B,T] int32; 2 <= Sw <= 8. impl: 0 = window_fwd with GB (2, 4 or
// 8) window rows per block (the last of a KV head's ceil(G*Sw / GB) groups
// may be partial), S splits of `split` slots (a multiple of the lane
// loop's step); 1 = window_mma for bf16, S splits of `split` slots (a
// multiple of 64), GB unused. ws: the fp32 workspace of split_merge.cuh
// for B*Hq*Sw rows, [B*Hq*Sw*S*(D+2)], at every S. Returns
// cudaGetLastError() after the last launch.
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
    if (dtype == kBF16) err = dispatch_mma(D, a, s);
  } else if (impl == 0) {
    if (dtype == kF32) err = dispatch_d<float>(D, GB, a, s);
    if (dtype == kBF16) err = dispatch_d<__nv_bfloat16>(D, GB, a, s);
    if (dtype == kF16) err = dispatch_d<__half>(D, GB, a, s);
  }
  return static_cast<int>(err);
}
