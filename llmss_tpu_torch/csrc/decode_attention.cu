// K2: single-token decode attention over the layer-stacked KV cache.
//
// Replaces llmss_tpu/ops/pallas_decode.py::decode_attention (kernel body
// _kernel). Same function: for each row b and query head h, one exact
// softmax over the slots t < t_len of layer `layer` of the STALE cache
// [L, B, T, Hkv, D] (current token not yet written) whose position is
// visible (0 <= kv_pos[b,t] <= q_pos[b], inside the window when set) and
// which is not the slot the current token is about to take
// (t != slots[b]: on a ring wrap this drops the token being overwritten),
// merged with the fresh token's own k_new / v_new. The fresh token always
// attends itself, so an empty cache yields exactly v_new. Scores, running
// max / sum and accumulators are fp32; P is rounded to the value dtype
// before P.V, as in the Pallas kernel. t_len bounds the read to the live
// ring prefix (the reference XLA path's t_bucket); the Pallas kernel always
// read the whole ring.
//
// Over an int8 cache (KV = int8_t, the engine's kv_dtype="int8") the same
// template computes what the reference's XLA oracle
// fresh_kv_decode_attention(k_scale=, v_scale=) (llmss_tpu/ops/
// attention.py:242) computes: the Pallas K2 takes no scales. Each slot's
// score is multiplied by its K scale after the Q.K dot and before the mask,
// and P by its V scale before P.V, in fp32 (P is not rounded); the fresh
// token's score and value are not scaled, and the split partials and
// split_merge.cuh are unchanged. The int8 rows halve the bytes a slot
// moves, in one 16-byte copy per lane and step: each lane copies a 16-byte
// chunk of the slot's K or V row and reads its 8 bytes of each back from
// its pair's chunks; a slot's two fp32 scales are copied once per window,
// by a lane of its warp; and each V row is widened once per step for all
// query heads, with byte permutes and fp32 adds instead of conversions
// (csrc/split_merge.cuh LaneRing<int8_t>, csrc/common.cuh Vec8<int8_t>).
//
// What bounds it on the H100: memory. Each (row, kv head) needs its
// t_len * D keys and values once and does ~4 flops per element for each of
// its G query heads, far below the ~295 flops per byte where the tensor
// cores would become the limit. So the design reads each KV head once per
// (row, split) for all G of its query heads, in one of two templates
// (ops/decode_attention.py kernel_plan):
//   * G <= 8, or fp32 / fp16 queries: decode_fwd, fp32 FMA lanes, GB
//     query heads a block (the least power of two at or above min(G, 8):
//     G = 7, Qwen2-7B's, takes one group of 8 with a dead row). Its fp32
//     state per head lives in registers, so GB stops at 8; at G <= 8 one
//     group is the whole KV head's. FMA keeps the fresh V in fp32 as the
//     Pallas kernel does. (Measured on the H100, PERF.md: the lanes beat
//     the tile at G = 1, the tile wins from G = 4; G_TILE stays 8 while
//     moving it would change GQA models' outputs.)
//   * bf16 queries with G > 8 (ops/split_plan.py G_TILE; StarCoder's 48
//     heads on one KV head): decode_mma, the tensor-core tile of
//     attn_tile.cuh (over an int8 cache attn_tile_i8.cuh) with its 64
//     flat rows the query heads of one KV head, where the lanes took 6
//     blocks of 8 heads that each streamed the same KV head. Split s reads
//     slots [s*split, (s+1)*split) as whole 64-slot tiles, the pending
//     slot hidden by its position, and stores each head's fp32 (m, l,
//     acc); split_merge always folds the splits and then the fresh token
//     in fp32, so the fresh V stays fp32. The cache's P is rounded to bf16
//     before P.V (over int8: P x v_scale as two bf16 terms).
// The lane template's design:
//   * the layer is addressed in place (cache + layer*B*T*Hkv*D), the GPU
//     form of the Pallas kernel's scalar-prefetched layer index: no
//     per-layer slice copy;
//   * one block per (row, kv head, group of GB <= 8 query heads, split s
//     of S along the slots: flash-decoding, csrc/split_merge.cuh): a KV
//     element is read once for all the query heads of the group
//     (GQA/MQA), and split s reads slots [s*split, (s+1)*split) of
//     [0, t_len). Without the split the engine's decode (batch 4, 32 kv
//     heads) launched 128 blocks for 132 SMs, each walking its whole read,
//     and GQA at batch 4 only 32; the host picks S from t_len and the
//     card's SM count (ops/split_plan.py): a long read splits until the
//     grid has two blocks per SM, and a read of at most two splits on a
//     grid that nearly fills the card stays whole, since there the merge
//     costs more than the shorter walk saves;
//   * every load the KV loop needs first (the row's scalars, its query
//     heads, the first kStage slots' positions) is issued before any is
//     used; the positions, already masked (empty, future, pending or
//     outside the window: -1), are staged in shared memory, so no K/V
//     load waits on a position load;
//   * each warp streams its slots' K and V rows through its own cp.async
//     ring of 4 stages (6 over an int8 cache) in shared memory (csrc/
//     split_merge.cuh LaneRing): the loads of all but one stage are in
//     flight while one is computed, and they hold no registers, so the
//     MHA instantiations fit three blocks on an SM; a step no lane of the
//     warp sees is skipped;
//   * every half-warp (D = 128) keeps its own running max / sum / output
//     over the slots it read; the partial states merge by shuffles, then
//     through shared memory (reusing the rings). At S = 1 the block folds
//     in the fresh token there and writes the output; at S > 1 it stores
//     its fp32 (m, l, acc) and split_merge, launched next on the same
//     stream, folds the splits in split order, then the fresh token.

#include "attn_tile.cuh"
#include "attn_tile_i8.cuh"
#include "common.cuh"
#include "split_merge.cuh"

namespace llmss {
namespace {

constexpr int NWARP = 8;
constexpr int NT = NWARP * 32;

struct Args {
  const void* q;   // [B, 1, Hq, D]
  const void* kc;  // [L, B, T, Hkv, D]
  const void* vc;
  const void* kn;  // [B, 1, Hkv, D]
  const void* vn;
  void* o;         // [B, 1, Hq, D]
  const int* qpos;   // [B]
  const int* kvpos;  // [B, T]
  const int* slots;  // [B]
  float* ws;         // split partials (split_merge.cuh), null at S = 1
  int layer, B, Tn, t_len, Hq, Hkv, S, split;
  float scale;
  int window;  // <= 0: full causal
};

// The int8-cache instantiations take Args and the per-(slot, KV head)
// scales [L, B, T, Hkv]; the others take Args alone, as before the int8
// cache (a parameter struct that grew, even at its end, changed their
// register allocation and slowed K2 by up to 7%, PERF.md).
struct ArgsI8 : Args {
  const float* ks;
  const float* vs;
};
template <typename KV> using ArgsOf = std::conditional_t<kQuant<KV>, ArgsI8, Args>;

template <typename KV, int D, int GB>
struct Cfg {
  static constexpr int LPS = D / 8;          // lanes per slot (8 elements each)
  static constexpr int SPW = 32 / LPS;       // slots per warp per step
  static constexpr int STEP = NWARP * SPW;   // slots per step of the block
  static constexpr int SLOTS = STEP * kSteps;  // slots per ring stage
  // The warps' K/V rings, reused by s_acc [NWARP][GB][D] once the KV loop
  // is done | s_m, s_l [NWARP][GB] | s_new [GB] | staged positions
  static constexpr size_t ring = size_t(NWARP) * LaneRing<KV>::WARP_BYTES;
  static constexpr size_t acc = sizeof(float) * NWARP * GB * D;
  static constexpr size_t region = ring > acc ? ring : acc;
  static constexpr size_t smem =
      region + sizeof(float) * (2 * NWARP * GB + GB) + sizeof(int) * kStage;
};

// T: the query / fresh KV / output type; KV: the cache's (T, or int8_t).
// kPart: GB does not divide G, so each KV head's last group of GB rows is
// partial (G = 7: one group of 8, one row dead); false compiles to the
// code of a G that GB divides, unchanged by the partial groups.
template <typename T, typename KV, int D, int GB, bool kPart = false>
__global__ void __launch_bounds__(NT, kLaneMinBlocks<T, GB>) decode_fwd(ArgsOf<KV> a) {
  using C = Cfg<KV, D, GB>;
  using Ring = LaneRing<KV>;
  constexpr int LPS = C::LPS, SPW = C::SPW;
  static_assert(!kQuant<KV> || NWARP * LaneRing<int8_t>::SCALE_SLOTS >= kStage);
  extern __shared__ __align__(16) float smem[];
  float* s_acc = smem;                       // [NWARP][GB][D], after the KV loop
  float* s_m = smem + C::region / sizeof(float);  // [NWARP][GB]
  float* s_l = s_m + NWARP * GB;             // [NWARP][GB]
  float* s_new = s_l + NWARP * GB;           // [GB] fresh-token scores
  int* s_pos = reinterpret_cast<int*>(s_new + GB);  // [kStage]

  pdl_trigger();  // split_merge may start; it waits for this grid's writes

  const T* q = static_cast<const T*>(a.q);
  const KV* kc = static_cast<const KV*>(a.kc);
  const KV* vc = static_cast<const KV*>(a.vc);
  const T* kn = static_cast<const T*>(a.kn);
  const T* vn = static_cast<const T*>(a.vn);
  T* o = static_cast<T*>(a.o);

  const int b = blockIdx.x;
  const int G = a.Hq / a.Hkv;
  const int ng = kPart ? (G + GB - 1) / GB : G / GB;  // head groups per KV head
  const int hk = blockIdx.y / ng;
  const int g0 = (blockIdx.y % ng) * GB;
  const int h0 = hk * G + g0;
  const int gn = kPart ? min(GB, G - g0) : GB;  // live heads: g < gn
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

  // Every load the KV loop needs first is issued here, before any is
  // used: the row's scalars, its query heads, and the first window's
  // positions (kStage / NT per thread).
  constexpr int PPT = kStage / NT;
  int pv[PPT];
  auto load_window = [&](int w0, int w1) {
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int t = w0 + j * NT + threadIdx.x;
      pv[j] = t < w1 ? kvp[t] : -1;
    }
  };
  const int qp = a.qpos[b];
  const int slot = a.slots[b];
  Vec8<T> qv[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g)
    if (g < gn) qv[g].load(q + ((long long)b * a.Hq + h0 + g) * D + e0);
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
  float ksc[kSteps], vsc[kSteps];  // int8 only: the step's slots' scales
  int st8 = 0;  // int8 only: the ring stage step() reads its V rows from
  // int8 only: the start of this lane's 16-byte copies, the K row (even
  // lane) or V row (odd) of its pair of lanes, less the slot's offset.
  const KV* src8 = lane & 1 ? vc + (base - 8) : kc + base;

  // Fold one step's slots (K/V rows and, int8, their scales read back
  // from the ring; int8: its V rows read here) into each head's running
  // softmax; ok[u]: slot u is visible.
  auto step = [&](const Vec8<KV>(&kv)[kSteps], const Vec8<KV>(&vv)[kSteps],
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
        if constexpr (kQuant<KV>) {
          s[u][g] = ok[u] ? d * a.scale * ksc[u] : kNegInf;
        } else {
          s[u][g] = ok[u] ? d * a.scale : kNegInf;
        }
      }
    }
    if constexpr (kQuant<KV>) {
      // int8: every head's rescale first, then slot by slot, so that each
      // V row is widened once for all of them (per head, the same
      // operations in the same order as below). P times the slot's V
      // scale, in fp32, as the oracle's P.V.
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
        m[g] = m_new;
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        if (!ok[u]) continue;  // masked slots contribute exactly 0
        float vf[8];
        Vec8<KV> v8;
        ring_get(v8, wring, st8, u, 1, lane);
        v8.to_float(vf);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          const float p = expf(s[u][g] - m[g]);
          l[g] += p;
          const float pr = p * vsc[u];
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pr, vf[e], acc[g][e]);
        }
      }
    } else {
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
          const float pr = round_to<KV>(p);
          float vf[8];
          vv[u].to_float(vf);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pr, vf[e], acc[g][e]);
        }
        m[g] = m_new;
      }
    }
  };

  for (int w0 = t_lo; w0 < t_hi; w0 += kStage) {
    const int w1 = min(t_hi, w0 + kStage);
    if (w0 != t_lo) load_window(w0, w1);
    __syncthreads();  // the previous window's staged slots are consumed
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int i = j * NT + threadIdx.x, t = w0 + i, p = pv[j];
      s_pos[i] = p >= 0 && p <= qp && t != slot &&
                         (a.window <= 0 || p > qp - a.window)
                     ? p
                     : -1;
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
            if constexpr (kQuant<KV>) {
              Ring::put(wring, i % Ring::STAGES, u, lane, src8 + (long long)t * row_stride);
            } else {
              const long long off = base + (long long)t * row_stride;
              Ring::put(wring, i % Ring::STAGES, u, lane, kc + off, vc + off);
            }
          }
        }
      }
      tile::cp_async_commit();  // empty past the window: keeps the count
    };
    if constexpr (kQuant<KV>) {
      // The scales ([L, B, T, Hkv]) of this warp's visible slots of the
      // window, lane j its slots j, j + 32, ... (k-th: step k / SPW, sub k %
      // SPW), in issue(0)'s group (csrc/split_merge.cuh LaneRing<int8_t>).
      const long long s0 = ((long long)a.layer * a.B + b) * a.Tn * a.Hkv + hk;
      for (int k = lane; k < n_st * kSteps * SPW; k += 32) {
        const int t = w0 + (k / SPW) * C::STEP + warp * SPW + k % SPW;
        if (t < w1 && s_pos[t - w0] >= 0) {
          const long long so = s0 + (long long)t * a.Hkv;
          Ring::put_scales(wring, k, a.ks + so, a.vs + so);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < Ring::STAGES - 1; ++i) issue(i);
    for (int i = 0; i < n_st; ++i) {
      // int8: every lane of the warp is done reading the stage issue()
      // copies into (csrc/split_merge.cuh has the ordering argument).
      if constexpr (kQuant<KV>) __syncwarp();
      issue(i + Ring::STAGES - 1);
      tile::cp_async_wait<Ring::STAGES - 1>();  // this lane's stage i landed
      if constexpr (kQuant<KV>) __syncwarp();  // int8: and every lane's
      Vec8<KV> kv[kSteps], vv[kSteps];
      bool ok[kSteps];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        const int t = slot_of(i, u);
        ok[u] = t < w1 && s_pos[t - w0] >= 0;
        if (ok[u]) {
          ring_get(kv[u], wring, i % Ring::STAGES, u, 0, lane);
          // int8: step() reads the V row where it widens it.
          if constexpr (!kQuant<KV>) ring_get(vv[u], wring, i % Ring::STAGES, u, 1, lane);
          if constexpr (kQuant<KV>) {
            ksc[u] = *Ring::scale_at(wring, 0, (i * kSteps + u) * SPW + sub);
            vsc[u] = *Ring::scale_at(wring, 1, (i * kSteps + u) * SPW + sub);
          }
        }
      }
      if constexpr (kQuant<KV>) st8 = i % Ring::STAGES;
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
  if (a.S > 1) {
    __syncthreads();
    store_partial<NWARP, D, GB>(s_acc, s_m, s_l, a.ws, a.B, a.Hq, a.S, b,
                                split, [&](int g) { return g < gn ? h0 + g : -1; });
    return;
  }
  // Fresh-token scores: warp g computes head g's q . k_new.
  if (warp < gn) {
    float d = 0.f;
    const T* knp = kn + ((long long)b * a.Hkv + hk) * D;
    const T* qh = q + ((long long)b * a.Hq + h0 + warp) * D;
    for (int e = lane; e < D; e += 32) d = fmaf(to_f<T>(qh[e]), to_f<T>(knp[e]), d);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    if (lane == 0) s_new[warp] = d * a.scale;
  }
  __syncthreads();

  const T* vnp = vn + ((long long)b * a.Hkv + hk) * D;
  for (int i = threadIdx.x; i < gn * D; i += NT) {
    const int g = i / D, d = i % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) M = fmaxf(M, s_m[w * GB + g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const float x = expf(s_m[w * GB + g] - M);
      L += s_l[w * GB + g] * x;
      O += s_acc[(w * GB + g) * D + d] * x;
    }
    const float sn = s_new[g];
    const float M2 = fmaxf(M, sn);
    const float alpha = expf(M - M2);
    const float pn = expf(sn - M2);
    const float out = (O * alpha + pn * to_f<T>(vnp[d])) / (L * alpha + pn);
    o[((long long)b * a.Hq + h0 + g) * D + d] = from_f<T>(out);
  }
}

// The split kernel, then at S > 1 split_merge on the same stream. A split
// is whole ring stages, and S splits cover [0, t_len).
template <typename T, typename KV, int D, int GB>
cudaError_t launch(const ArgsI8& a, cudaStream_t stream) {
  if (a.S < 1 || a.S > kMaxSplits || a.split <= 0 ||
      a.split % Cfg<KV, D, GB>::SLOTS || (long long)a.S * a.split < a.t_len ||
      (a.S > 1 && a.ws == nullptr) ||
      (kQuant<KV> && (a.ks == nullptr || a.vs == nullptr)))
    return cudaErrorInvalidValue;
  constexpr size_t smem = Cfg<KV, D, GB>::smem;
  auto kern = decode_fwd<T, KV, D, GB>;
  if ((a.Hq / a.Hkv) % GB) {  // partial groups: GB is 4 (G = 3) or 8
    if constexpr (GB >= 4) {
      kern = decode_fwd<T, KV, D, GB, true>;
    } else {
      return cudaErrorInvalidValue;
    }
  }
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B, a.Hkv * ((a.Hq / a.Hkv + GB - 1) / GB), a.S);
  kern<<<grid, NT, smem, stream>>>(static_cast<const ArgsOf<KV>&>(a));
  err = cudaGetLastError();
  if (err != cudaSuccess || a.S == 1) return err;
  const MergeArgs m{a.q, a.kn, a.vn, a.o, a.ws, nullptr, nullptr, a.B, a.Hq,
                    a.Hkv, a.S, a.split, 1, 0, a.scale};
  return launch_merge<T>(D, m, stream);
}

template <typename T, typename KV, int D>
cudaError_t dispatch_g(int GB, const ArgsI8& a, cudaStream_t s) {
  switch (GB) {
    case 1: return launch<T, KV, D, 1>(a, s);
    case 2: return launch<T, KV, D, 2>(a, s);
    case 4: return launch<T, KV, D, 4>(a, s);
    case 8: return launch<T, KV, D, 8>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename KV>
cudaError_t dispatch_d(int D, int GB, const ArgsI8& a, cudaStream_t s) {
  switch (D) {
    case 64: return dispatch_g<T, KV, 64>(GB, a, s);
    case 128: return dispatch_g<T, KV, 128>(GB, a, s);
    case 256: return dispatch_g<T, KV, 256>(GB, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// -- bf16 queries with G > 8 heads on a KV head: the tensor-core tile -------

// tile::attend's Source for one block of decode_mma: query heads
// hk*G + f0 .. + 63 of row b (flat row r is head f0 + r of the group, all
// at position qp) against split s's slots [t_lo, t_hi) of layer `layer`,
// addressed from t_lo: slot x is ring slot t_lo + x, hidden when it is
// empty, the pending slot, or at or past t_hi.
template <int D>
struct DenseSrc {
  using T = __nv_bfloat16;
  const T *q, *kc, *vc;
  const int* kvp;  // row b's positions from t_lo
  int f0, G, hq0, qp, slot, t_end;  // hq0 = b*Hq + hk*G; slot, t_end from t_lo
  long long base, row_stride;  // slot t_lo's K/V row of head hk; Hkv * D
  int n_tiles, qmax, qmin, window;
  float scale_log2;

  __device__ bool has(int r) const { return f0 + r < G; }
  __device__ const T* q_row(int r) const {
    return has(r) ? q + (long long)(hq0 + f0 + r) * D : nullptr;
  }
  __device__ int q_pos(int r) const { return has(r) ? qp : -1; }
  __device__ int slot_pos(int t, int j) const {
    const int x = t * tile::kSlots + j;
    return x < t_end && x != slot ? kvp[x] : -1;
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

// tile::attend_i8's Source over an int8 cache: DenseSrc (kc / vc unused),
// the int8 rows and their scales [L, B, T, Hkv], whose offset is the row's
// element offset / D.
template <int D>
struct DenseSrcI8 : DenseSrc<D> {
  const int8_t *kq, *vq;
  const float *ks, *vs;
  int n_cache;  // every tile is the cache's

  __device__ bool rows8(int t, int j, const int8_t*& kr, const int8_t*& vr,
                        long long& so) const {
    const int x = t * tile::kSlots + j;
    if (x >= this->t_end) return false;
    const long long off = this->base + x * this->row_stride;
    kr = kq + off;
    vr = vq + off;
    so = off / D;
    return true;
  }
};

// One block per (row b, KV head hk, 64 of its G query heads, split s of
// S): slots [s * split, (s + 1) * split) of [0, t_len) on the tensor-core
// tile; it stores each query head's fp32 (m, l, acc) for split_merge.
template <typename KV, int D>
__global__ void __launch_bounds__(tile::kThreads) decode_mma(ArgsOf<KV> a) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  pdl_trigger();  // split_merge may start; it waits for this grid's writes
  const int b = blockIdx.x, hk = blockIdx.y;
  const int G = a.Hq / a.Hkv;
  const int split = blockIdx.z % a.S, f0 = blockIdx.z / a.S * tile::kRows;
  const int t_lo = split * a.split, t_hi = min(a.t_len, t_lo + a.split);
  tile::WithPartial<std::conditional_t<kQuant<KV>, DenseSrcI8<D>, DenseSrc<D>>> s;
  s.q = static_cast<const T*>(a.q);
  if constexpr (kQuant<KV>) {
    s.kc = s.vc = nullptr;
    s.kq = static_cast<const int8_t*>(a.kc);
    s.vq = static_cast<const int8_t*>(a.vc);
    s.ks = a.ks;
    s.vs = a.vs;
  } else {
    s.kc = static_cast<const T*>(a.kc);
    s.vc = static_cast<const T*>(a.vc);
  }
  s.kvp = a.kvpos + (long long)b * a.Tn + t_lo;
  s.f0 = f0;
  s.G = G;
  s.hq0 = b * a.Hq + hk * G;
  s.qp = a.qpos[b];
  s.slot = a.slots[b] - t_lo;
  s.t_end = t_hi - t_lo;
  s.row_stride = (long long)a.Hkv * D;
  s.base = (((long long)a.layer * a.B + b) * a.Tn + t_lo) * s.row_stride + (long long)hk * D;
  s.n_tiles = (s.t_end + tile::kSlots - 1) / tile::kSlots;
  s.qmax = s.qmin = s.qp;
  s.window = a.window;
  s.scale_log2 = a.scale * 1.4426950408889634f;
  s.part = {a.ws, (long long)a.B * a.Hq * a.S,
            ((long long)b * a.Hq + hk * G + f0) * a.S + split, a.S,
            min(tile::kRows, G - f0)};
  if constexpr (kQuant<KV>) {
    s.n_cache = s.n_tiles;
    tile::attend_i8<D>(s, tile_smem);
  } else {
    tile::attend<T, D, true>(s, tile_smem);
  }
}

// decode_mma in S splits of `split` slots (whole 64-slot tiles covering
// [0, t_len)), then split_merge on the same stream, whatever S.
template <typename KV, int D>
cudaError_t launch_mma(const ArgsI8& a, cudaStream_t stream) {
  if (a.S < 1 || a.S > kMaxSplits || a.split <= 0 || a.split % tile::kSlots ||
      (long long)a.S * a.split < a.t_len || a.ws == nullptr ||
      (kQuant<KV> && (a.ks == nullptr || a.vs == nullptr)))
    return cudaErrorInvalidValue;
  constexpr size_t smem = kQuant<KV> ? tile::SmemI8<D>::bytes : tile::Smem<D>::bytes;
  auto kern = decode_mma<KV, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.Hq / a.Hkv + tile::kRows - 1) / tile::kRows;
  dim3 grid(a.B, a.Hkv, tiles * a.S);
  kern<<<grid, tile::kThreads, smem, stream>>>(static_cast<const ArgsOf<KV>&>(a));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const MergeArgs m{a.q, a.kn, a.vn, a.o, a.ws, nullptr, nullptr, a.B, a.Hq,
                    a.Hkv, a.S, a.split, 1, 0, a.scale};
  return launch_merge<__nv_bfloat16>(D, m, stream);
}

template <typename KV>
cudaError_t dispatch_mma(int D, const ArgsI8& a, cudaStream_t s) {
  switch (D) {
    case 64: return launch_mma<KV, 64>(a, s);
    case 128: return launch_mma<KV, 128>(a, s);
    case 256: return launch_mma<KV, 256>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace llmss

// q [B,1,Hq,D], cache [L,B,T,Hkv,D], k_new / v_new [B,1,Hkv,D], out
// [B,1,Hq,D], all contiguous; q_pos / slots [B] and kv_pos [B,T] int32.
// impl: 0 = decode_fwd with GB (1, 2, 4 or 8) query heads per block (the
// last of a KV head's ceil(Hq/Hkv / GB) groups may be partial), S splits
// of `split` slots (a multiple of the lane loop's step; ws the fp32
// workspace of split_merge.cuh, [B*Hq*S*(D+2)], null at S = 1); 1 =
// decode_mma over a bf16 cache and 2 = decode_mma over an int8 cache, for
// bf16 queries: S splits of `split` slots (a multiple of 64), ws required
// at every S, GB unused. window <= 0 means full causal. kv_dtype: the
// cache's dtype, dtype's own, or kI8 under fp32 or bf16 queries, with
// k_scale / v_scale [L,B,T,Hkv] fp32 (null otherwise). Returns
// cudaGetLastError() after the last launch.
extern "C" int llmss_decode_attention(void* q, void* kc, void* vc, void* kn,
                                      void* vn, void* o, void* qpos,
                                      void* kvpos, void* slots, void* ws,
                                      int layer, int B, int T, int t_len,
                                      int Hq, int Hkv, int D, int GB, int S,
                                      int split, int dtype, float scale,
                                      int window, void* stream, void* k_scale,
                                      void* v_scale, int kv_dtype, int impl) {
  using namespace llmss;
  if (B == 0) return 0;
  const ArgsI8 a{{q, kc, vc, kn, vn, o,
                 static_cast<const int*>(qpos), static_cast<const int*>(kvpos),
                 static_cast<const int*>(slots), static_cast<float*>(ws),
                 layer, B, T, t_len, Hq, Hkv, S, split, scale, window},
                static_cast<const float*>(k_scale),
                static_cast<const float*>(v_scale)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (impl == 1) {
    if (dtype == kBF16 && kv_dtype == kBF16) err = dispatch_mma<__nv_bfloat16>(D, a, s);
  } else if (impl == 2) {
    if (dtype == kBF16 && kv_dtype == kI8) err = dispatch_mma<int8_t>(D, a, s);
  } else if (impl == 0 && kv_dtype == dtype) {
    if (dtype == kF32) err = dispatch_d<float, float>(D, GB, a, s);
    if (dtype == kBF16) err = dispatch_d<__nv_bfloat16, __nv_bfloat16>(D, GB, a, s);
    if (dtype == kF16) err = dispatch_d<__half, __half>(D, GB, a, s);
  } else if (impl == 0 && kv_dtype == kI8) {
    if (dtype == kF32) err = dispatch_d<float, int8_t>(D, GB, a, s);
    if (dtype == kBF16) err = dispatch_d<__nv_bfloat16, int8_t>(D, GB, a, s);
  }
  return static_cast<int>(err);
}
