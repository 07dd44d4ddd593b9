// The tensor-core attention tile shared by K1 (flash_attention.cu), K4
// (paged_attention.cu) in bf16 / f16, and the decode kernels K2 and K3 (K4
// at CB = 1) when G > 8 query heads share a KV head.
//
// One block of 4 warps attends 64 flat query rows (16 per warp) against a
// sequence of 64-slot KV tiles that a Source describes (strided prefill
// K/V for K1; a gather through the block tables, then the fresh chunk, for
// K4; one split's range of a row's cache for the decode kernels). A flat
// row f = i*G + g is query i under query head hk*G + g, so the G query
// heads of one KV head share every K/V byte the block loads.
//
//   * KV pipeline: K and V tiles double-buffered in shared memory, filled by
//     cp.async.cg 16-byte copies; slots past the end are zero-filled by the
//     copy's src-size. Rows are padded by 16 bytes, so the ldmatrix reads
//     of 8 rows hit 32 different banks.
//   * Tile skipping: before a tile's copy is issued, every warp reads the
//     tile's 64 positions (four tiles ahead at a time) and votes; a tile no
//     row of the block can see is never copied. Warp 0 leaves the positions
//     of the tile it found in shared memory, in the same stage as its K/V,
//     for the per-element masks.
//   * S = Q.K^T and O += P.V: mma.sync m16n8k16 (fp32 accumulate), operands
//     by ldmatrix (.trans for V). Q stays in shared memory.
//   * Online softmax in registers: each thread holds 2 rows x 16 slots of
//     S; the row max is reduced over the quad (shfl_xor 1, 2), the row sum
//     per thread and once over the quad at the end. Scores are scaled by
//     scale*log2(e) and exponentiated with exp2f.
//   * P is converted from the fp32 accumulator fragment to a 16-bit A
//     fragment in registers: the rounding to the value dtype that the
//     Pallas kernels do before P.V. The row sum uses the unrounded P.
//
// Masks are per element from positions: slot position p is visible to a
// row at position q when 0 <= p <= q and (with a window) p > q - window.
// A Source returns -1 for slots it hides (empty, pending, past the end).
// kZeroMasked: masked probabilities are exactly 0 (K4, pallas_ragged.py
// :157); otherwise exp2(kNegInf - m), which is 0 once the row has a real
// max and 1 while it has none, so a row masked everywhere in the live
// tiles ends as their uniform average (K1, common.cuh).
//
// Output: each row's o / l rounded to T at src.o_row(r); or, for a Source
// with kPartial (WithPartial below: the decode kernels' splits), the
// row's fp32 state (acc = o unnormalised, m, l) in split_merge.cuh's
// workspace, which split_merge folds with the other splits and the fresh
// key.
#pragma once

#include <utility>

#include "common.cuh"

namespace llmss {
namespace tile {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 64;   // flat query rows per block, 16 per warp
constexpr int kSlots = 64;  // KV slots per tile
constexpr int kLook = 4;    // tiles whose positions one liveness probe reads

// Shared memory: Q [kRows][LD] | K [2][kSlots][LD] | V [2][kSlots][LD] |
// positions [2][kSlots]. Mirrored by ops/_build.py::tile_smem_bytes.
template <int D> struct Smem {
  static constexpr int LD = D + 8;  // 16 bytes of padding per row
  static constexpr int Q = kRows * LD;
  static constexpr int KV = kSlots * LD;
  static constexpr size_t bytes =
      2 * (size_t(Q) + 4 * size_t(KV)) + 2 * kSlots * sizeof(int);
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d (16x8 fp32) += a (16x16, row) * b (16x8, col).
template <typename T>
__device__ __forceinline__ void mma(float d[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float d[4],
                                                   const uint32_t a[4],
                                                   uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma<__half>(float d[4], const uint32_t a[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values rounded to T, lo in the low half.
template <typename T> __device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ bool sees(int p, int q, int window) {
  return p >= 0 && p <= q && (window <= 0 || p > q - window);
}

// Where a decode block leaves its partial softmax states: split_merge.cuh's
// workspace, acc [B, Hq, S, D], then m [B, Hq, S], then l [B, Hq, S]. The
// block's flat row r (< n) is state row row0 + r * S: query head h0 + r of
// row b, split s (row0 = (b * Hq + h0) * S + s).
struct PartialOut {
  float* ws;
  long long n_part;  // B * Hq * S
  long long row0;
  int S, n;
};

// A Source whose block stores partial states instead of outputs.
template <class Src>
struct WithPartial : Src {
  static constexpr bool kPartial = true;
  PartialOut part;
};

template <class Src, class = void>
struct StoresPartial : std::false_type {};
template <class Src>
struct StoresPartial<Src, std::void_t<decltype(Src::kPartial)>>
    : std::bool_constant<Src::kPartial> {};

// The block's end, for this thread's rows row0 and row0 + 8 (quad t4 of
// each): its running max m (scores in log2 units), its share l of the row
// sum and its fragment o of the unnormalised output.
template <typename T, int D, class Src>
__device__ __forceinline__ void finish(const Src& src, int row0, int t4, const float (&m)[2],
                                       const float (&l)[2], const float (&o)[D / 8][4]) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float sum = l[rr];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int r = row0 + 8 * rr;
    if constexpr (StoresPartial<Src>::value) {
      const PartialOut& p = src.part;
      if (r >= p.n) continue;
      const long long row = p.row0 + (long long)r * p.S;
      float* acc = p.ws + row * D;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<float2*>(acc + n * 8 + 2 * t4) =
            make_float2(o[n][2 * rr], o[n][2 * rr + 1]);
      if (t4 == 0) {
        // split_merge takes m in the natural-log units of its scores.
        p.ws[p.n_part * D + row] = m[rr] == kNegInf ? kNegInf : m[rr] * 0.6931471805599453f;
        p.ws[p.n_part * D + p.n_part + row] = sum;
      }
    } else {
      T* orow = src.o_row(r);
      if (orow == nullptr) continue;
      const float den = sum == 0.f ? 1.f : sum;  // no visible slot: 0
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t4) =
            pack2<T>(o[n][2 * rr] / den, o[n][2 * rr + 1] / den);
    }
  }
}

// Source interface (all __device__, called with r in [0, kRows), j in
// [0, kSlots)):
//   int n_tiles, qmax, qmin, window;  float scale_log2;
//   const T* q_row(int r)   query row of flat row r, nullptr if none
//   int q_pos(int r)        its position, -1 if none
//   T* o_row(int r)         where its output goes, nullptr if nowhere
//                           (a WithPartial Source has `part` instead)
//   int slot_pos(int t, int j)  position of slot j of tile t, -1 if hidden
//   bool rows(int t, int j, const T*& k, const T*& v)  its K/V rows; false
//                           past the end (zero-filled)
//   const T* any_ptr()      a valid address for zero-filling copies
// qmax / qmin: the latest and earliest position among the block's rows.
template <typename T, int D, bool kZeroMasked, class Src>
__device__ __forceinline__ void attend(const Src& src, unsigned char* smem) {
  using SM = Smem<D>;
  constexpr int LD = SM::LD;
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + SM::Q;
  T* sV = sK + 2 * SM::KV;
  int* sPos = reinterpret_cast<int*>(sV + 2 * SM::KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_tiles = src.n_tiles;

  for (int c = tid; c < kRows * CPR; c += kThreads) {
    const int r = c / CPR, part = c % CPR;
    const T* g = src.q_row(r);
    cp_async16(sQ + r * LD + part * 8, g ? g + part * 8 : src.any_ptr(),
               g != nullptr);
  }

  // A slot some row of the block can see: visible to the latest row, and
  // inside the earliest row's window.
  auto live = [&](int p) {
    return p >= 0 && p <= src.qmax &&
           (src.window <= 0 || p > src.qmin - src.window);
  };
  // The first tile at or after t that a row of the block can see (n_tiles
  // if none); p0 / p1 end as its positions of slots lane and lane + 32.
  // Every warp computes the same answer from the same positions.
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
  auto issue = [&](int t, int stage) {
    T* k = sK + stage * SM::KV;
    T* v = sV + stage * SM::KV;
    for (int c = tid; c < kSlots * CPR; c += kThreads) {
      const int j = c / CPR, part = c % CPR;
      const T *kr, *vr;
      const bool ok = src.rows(t, j, kr, vr);
      cp_async16(k + j * LD + part * 8, ok ? kr + part * 8 : src.any_ptr(), ok);
      cp_async16(v + j * LD + part * 8, ok ? vr + part * 8 : src.any_ptr(), ok);
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
    const int nxt = next_live(cur + 1, p0, p1);
    if (nxt < n_tiles) {
      if (warp == 0) {
        sPos[(stage ^ 1) * kSlots + lane] = p0;
        sPos[(stage ^ 1) * kSlots + lane + 32] = p1;
      }
      issue(nxt, stage ^ 1);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the copy just issued
    __syncthreads();

    const T* k = sK + stage * SM::KV;
    const T* v = sV + stage * SM::KV;
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
        ldsm_x4(b, k + (nn * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                       ((lane >> 3) & 1) * 8);
        mma<T>(s[2 * nn], a, b[0], b[1]);
        mma<T>(s[2 * nn + 1], a, b[2], b[3]);
      }
    }

    // Mask, scale, online softmax. Element e of n-tile n: row row0 + 8*(e/2),
    // slot 8n + 2*t4 + e%2.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = pos[n * 8 + 2 * t4 + (e & 1)];
        const bool vis = sees(p, qp[e >> 1], window);
        s[n][e] = vis ? s[n][e] * src.scale_log2 : kNegInf;
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
        const float p = (kZeroMasked && x == kNegInf) ? 0.f : exp2f(x - mx[e >> 1]);
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

    // O += P V: P (16 x 64) as four 16-slot A fragments, V by ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {
          pack2<T>(s[2 * kk][0], s[2 * kk][1]),
          pack2<T>(s[2 * kk][2], s[2 * kk][3]),
          pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t b[4];
        ldsm_x4_trans(b, v + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                             nd * 16 + (lane >> 4) * 8);
        mma<T>(o[2 * nd], a, b[0], b[1]);
        mma<T>(o[2 * nd + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage's buffers are free for the next copy
    cur = nxt;
    stage ^= 1;
  }
  cp_async_wait<0>();
  finish<T, D>(src, row0, t4, m, l, o);
}

}  // namespace tile
}  // namespace llmss
