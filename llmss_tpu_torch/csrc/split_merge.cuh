// The lane template's KV loop and its split over the KV axis
// (flash-decoding), shared by K2 (decode_attention.cu) and K3
// (paged_attention.cu at CB = 1).
//
// KV loop. A block first stages its slots' positions (and, paged, their
// table entries) in shared memory, kStage slots at a time, so no K/V load
// waits on a position or table load. Each warp then streams its slots'
// K and V rows through its own ring of LaneRing::STAGES stages in shared
// memory: a lane cp.async-copies its 16-byte chunks of a slot's rows and
// later reads back exactly those chunks, so the ring needs no barrier, and
// the loads of STAGES - 1 stages are in flight while one is computed,
// costing no registers.
//
// Over an int8 cache (LaneRing<int8_t>) a lane still holds 8 elements of a
// slot's K row and 8 of its V row, but those are 8 bytes each, and the
// copies are 16 bytes: a slot's K and V rows are D / 8 16-byte chunks, one
// for each of its LPS lanes. Of each pair of lanes (2c, 2c + 1) of a slot,
// the even lane copies the pair's 16 bytes of the K row and the odd lane
// those of the V row, to where the pair reads them back. A step's rows sit
// in lane order (the K rows of its slots, then their V rows), so a warp's
// 8-byte reads are conflict-free. The scales (one fp32 K and V scale per
// slot, 4 bytes each, one 32-byte sector apiece in device memory) are
// copied once per window instead, in the ring's first stage's commit
// group, to the window area of the warp that reads them, where each lane
// of a slot reads them as a shared-memory broadcast. In K2 lane j of a
// warp copies the scales of the warp's slots j, j + 32, ...; in K3 the
// thread that stages a slot's position does (it reads the slot's table
// entry beside the position for that), which takes the scales' address
// arithmetic and table reads off the warps' path to their first stage.
// Per stage, a warp so issues one 16-byte copy a lane; copying a slot's
// scales with its rows would add two 4-byte copies per slot and step. A
// lane reads bytes that other lanes of its warp copied, and copies into a
// stage that they read on the ring's previous lap, so the int8 loop takes
// two __syncwarp()s per stage, both outside every per-slot test and the
// skip of steps no lane sees, so that every lane reaches them:
//   * after cp_async_wait: each lane's copies into stage i (and, at i = 0,
//     its scale copies) are complete and visible to itself; the barrier
//     (which orders shared memory among the warp's lanes) makes them
//     visible to the lanes that read them. At i = 0 K3 takes a
//     __syncthreads() instead: other warps' threads copied its scales;
//   * before issue(i + STAGES - 1), which copies into the stage the warp
//     read on iteration i - 1: every lane's reads of it are done. The
//     shuffles in between are not memory fences.
// The window's __syncthreads() order the first stages and the scales of a
// window after the previous window's reads.
//
// Split. A split kernel's block reads one range of a row's slots and
// leaves one fp32 partial softmax state per query head in a workspace the
// wrapper allocates (llmss_tpu_torch/ops/split_plan.py
// ``workspace_numel``): acc [B, Hq, S, D], then m [B, Hq, S], then
// l [B, Hq, S]. A split that sees no visible slot leaves m = kNegInf,
// l = 0, acc = 0. split_merge, launched next on the same stream, then
// folds, per (row, query head), the row's live splits in split order (a
// fixed order: the output does not depend on which block finished first,
// and no atomics touch the data), then the fresh token's key and value
// last, and writes the output. The fresh score is fp32 and the fresh V is
// applied in fp32, as in the unsplit kernels. The merge is a programmatic
// dependent launch: its blocks start while the split kernel's last blocks
// run, compute the fresh key's score, and wait (griddepcontrol.wait) only
// before they read the partials.

#pragma once

#include "attn_tile.cuh"
#include "common.cuh"

namespace llmss {

// Slots whose positions (and table entries) a lane-template block stages
// in shared memory before it issues their K/V loads (ops/split_plan.py
// STAGE_SLOTS).
constexpr int kStage = 512;
// Steps (of SPW slots per warp) in one ring stage (ops/split_plan.py
// lane_step).
constexpr int kSteps = 2;
// Most splits split_merge folds (ops/split_plan.py MAX_SPLITS).
constexpr int kMaxSplits = 16;

// Occupancy of the lane-template instantiations with 16-bit queries (T),
// over a 16-bit or an int8 cache, by query rows per block: R <= 2 (MHA
// decode) is held to 85 registers, three blocks per SM; R == 4 (G = 4) to
// 128, two. The rings' 64 KB (52 KB for int8) allow three.
template <typename T, int R>
constexpr int kLaneMinBlocks = sizeof(T) != 2 ? 1 : R <= 2 ? 3 : R == 4 ? 2 : 1;

// Shared memory of the staged positions and, for a paged read (bs > 1),
// the staged table entries: a window of kStage slots spans at most
// kStage / bs + 2 table columns.
inline size_t stage_bytes(int bs) {
  return sizeof(int) * (size_t(kStage) + (bs > 1 ? kStage / bs + 2 : 0));
}

// One warp's ring of K/V chunks (ops/split_plan.py lane_region_bytes).
template <typename T> struct LaneRing {
  static constexpr int NC = sizeof(T) == 4 ? 2 : 1;  // 16-byte chunks a lane holds of a row
  static constexpr int EPC = 16 / sizeof(T);         // elements per chunk
  static constexpr int STAGES = sizeof(T) == 4 ? 2 : 4;
  static constexpr int STAGE_BYTES = kSteps * 2 * NC * 32 * 16;
  static constexpr int WARP_BYTES = STAGES * STAGE_BYTES;

  // Chunk c of lane `lane`'s K (kv 0) or V (kv 1) row of step u in stage
  // st: a warp's 32 lanes hold 512 consecutive bytes, conflict-free.
  __device__ static char* at(char* ring, int st, int u, int kv, int c, int lane) {
    return ring + st * STAGE_BYTES + (((u * 2 + kv) * NC + c) * 32 + lane) * 16;
  }
  __device__ static void put(char* ring, int st, int u, int lane, const T* k,
                             const T* v) {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      tile::cp_async16(at(ring, st, u, 0, c, lane), k + c * EPC, true);
      tile::cp_async16(at(ring, st, u, 1, c, lane), v + c * EPC, true);
    }
  }
};

// 4 bytes global -> shared (cp.async.cg takes 16 only).
__device__ __forceinline__ void cp_async_ca4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(tile::smem_addr(dst)),
               "l"(src));
}

// The int8 ring (ops/split_plan.py lane_region_bytes): per stage and step,
// the K rows of the warp's SPW slots (SPW * D = 256 bytes: lane `lane`
// reads bytes [8 lane, 8 lane + 8)), then their V rows; after the stages,
// the fp32 K scales, then V scales, of the warp's slots of one window of
// kStage slots, in the order the warp reads them.
template <> struct LaneRing<int8_t> {
  static constexpr int STAGES = 6;
  static constexpr int ROWS_BYTES = 32 * 8;  // a step's K (or V) rows
  static constexpr int STAGE_BYTES = kSteps * 2 * ROWS_BYTES;
  static constexpr int SCALE_SLOTS = kStage / 8;  // a warp's slots of a window, of 8 warps
  static constexpr int WARP_BYTES = STAGES * STAGE_BYTES + 2 * SCALE_SLOTS * 4;

  // Lane `lane`'s 8 bytes of its slot's K (kv 0) or V (kv 1) row of step u
  // in stage st.
  __device__ static char* at(char* ring, int st, int u, int kv, int lane) {
    return ring + st * STAGE_BYTES + (u * 2 + kv) * ROWS_BYTES + lane * 8;
  }
  // The K (kv 0) or V (kv 1) scale of the warp's k-th slot of the window.
  __device__ static float* scale_at(char* ring, int kv, int k) {
    return reinterpret_cast<float*>(ring + STAGES * STAGE_BYTES) + kv * SCALE_SLOTS + k;
  }
  // Lane `lane`'s one 16-byte copy of a step, of the pair of lanes lane &
  // ~1 and lane | 1 (a slot has an even number of lanes): the even lane
  // copies the pair's 16 bytes of the slot's K row, the odd one those of
  // its V row, into the bytes the pair reads back.
  __device__ static void put(char* ring, int st, int u, int lane, const int8_t* src) {
    tile::cp_async16(at(ring, st, u, lane & 1, lane & ~1), src, true);
  }
  // The warp's k-th slot's K and V scales.
  __device__ static void put_scales(char* ring, int k, const float* ks, const float* vs) {
    cp_async_ca4(scale_at(ring, 0, k), ks);
    cp_async_ca4(scale_at(ring, 1, k), vs);
  }
};

template <typename T>
__device__ __forceinline__ void ring_get(Vec8<T>& x, char* ring, int st, int u,
                                         int kv, int lane) {
  x.raw = *reinterpret_cast<const uint4*>(LaneRing<T>::at(ring, st, u, kv, 0, lane));
}
__device__ __forceinline__ void ring_get(Vec8<float>& x, char* ring, int st,
                                         int u, int kv, int lane) {
  x.a = *reinterpret_cast<const float4*>(LaneRing<float>::at(ring, st, u, kv, 0, lane));
  x.b = *reinterpret_cast<const float4*>(LaneRing<float>::at(ring, st, u, kv, 1, lane));
}
__device__ __forceinline__ void ring_get(Vec8<int8_t>& x, char* ring, int st,
                                         int u, int kv, int lane) {
  x.raw = *reinterpret_cast<const uint2*>(LaneRing<int8_t>::at(ring, st, u, kv, lane));
}

// Programmatic dependent launch (sm_90): let the next grid on the stream
// start, and wait for the previous one's completion and its writes.
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Fold a block's NW per-warp states (s_acc [NW][R][D], s_m / s_l [NW][R],
// the lane template's layout) into one state per query row and store it
// as split `split` of row b. head_of(r) is query row r's head, or -1 for
// a row past the block's tile. Call after a __syncthreads().
template <int NW, int D, int R, typename HeadOf>
__device__ __forceinline__ void store_partial(
    const float* s_acc, const float* s_m, const float* s_l, float* ws,
    int B, int Hq, int S, int b, int split, HeadOf head_of) {
  const long long n_part = (long long)B * Hq * S;
  for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D;
    const int h = head_of(r);
    if (h < 0) continue;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, s_m[w * R + r]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float mw = s_m[w * R + r];
      const float sc = mw == kNegInf ? 0.f : expf(mw - M);
      L += s_l[w * R + r] * sc;
      O += s_acc[(w * R + r) * D + d] * sc;
    }
    const long long row = ((long long)b * Hq + h) * S + split;
    ws[row * D + d] = O;
    if (d == 0) {
      ws[n_part * D + row] = M;
      ws[n_part * D + n_part + row] = L;
    }
  }
}

struct MergeArgs {
  const void* q;   // [B, 1, Hq, D]
  const void* kn;  // [B, 1, Hkv, D]
  const void* vn;
  void* o;         // [B, 1, Hq, D]
  const float* ws;
  const int* nblk;  // [B] occupied table columns (K3), or null: all S live (K2)
  const int* qlen;  // [B] live queries (K4 at CB = 1), or null: all 1
  int B, Hq, Hkv, S, split, bs, n_cols;
  float scale;
};

// One block of D threads per (row, query head); thread d owns feature d.
template <typename T, int D>
__global__ void __launch_bounds__(D) split_merge(MergeArgs a) {
  __shared__ float red[D / 32];
  const int b = blockIdx.x, h = blockIdx.y, d = threadIdx.x;
  const int hk = h / (a.Hq / a.Hkv);
  T* o = static_cast<T*>(a.o) + ((long long)b * a.Hq + h) * D;
  // The split kernel writes no output: chunk padding gets its zeros here,
  // as unsplit. Every path waits for the split kernel, so the stream's
  // next grid never overtakes it.
  if (a.qlen && a.qlen[b] < 1) {
    pdl_wait();
    o[d] = from_f<T>(0.f);
    return;
  }
  // Before the wait, only what the split kernel does not write: the
  // fresh key's score and value, and the number of live splits (splits at
  // or past the row's occupied slots returned at once).
  int live = a.S;
  if (a.nblk) {
    const int ncols = min(max(a.nblk[b], 0), a.n_cols);
    live = min(a.S, (ncols * a.bs + a.split - 1) / a.split);
  }
  const T* q = static_cast<const T*>(a.q) + ((long long)b * a.Hq + h) * D;
  const long long kv_off = ((long long)b * a.Hkv + hk) * D;
  const float v_new = to_f<T>(static_cast<const T*>(a.vn)[kv_off + d]);
  float x = to_f<T>(q[d]) * to_f<T>(static_cast<const T*>(a.kn)[kv_off + d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  if (d % 32 == 0) red[d / 32] = x;
  __syncthreads();
  float sn = 0.f;
#pragma unroll
  for (int w = 0; w < D / 32; ++w) sn += red[w];
  sn *= a.scale;

  pdl_wait();  // the split kernel's partials are complete and visible
  const long long n_part = (long long)a.B * a.Hq * a.S;
  const long long row0 = ((long long)b * a.Hq + h) * a.S;
  const float* acc = a.ws + row0 * D + d;
  const float* m = a.ws + n_part * D + row0;
  const float* l = m + n_part;
  // Every live split's state is loaded at once, then folded in order.
  float mv[kMaxSplits], lv[kMaxSplits], av[kMaxSplits];
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s < live) {
      mv[s] = m[s];
      lv[s] = l[s];
      av[s] = acc[(long long)s * D];
    }
  }
  float M = sn;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s)
    if (s < live) M = fmaxf(M, mv[s]);
  float den = 0.f, O = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxSplits; ++s) {
    if (s < live) {
      const float sc = mv[s] == kNegInf ? 0.f : expf(mv[s] - M);
      den += lv[s] * sc;
      O += av[s] * sc;
    }
  }
  const float pn = expf(sn - M);  // the fresh key, folded last
  den += pn;
  O += pn * v_new;
  o[d] = from_f<T>(O / den);
}

template <typename T, int D>
cudaError_t launch_merge_d(const MergeArgs& a, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B, a.Hq);
  cfg.blockDim = dim3(D);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, split_merge<T, D>, a);
}

template <typename T>
cudaError_t launch_merge(int D, const MergeArgs& a, cudaStream_t stream) {
  if (a.S > kMaxSplits) return cudaErrorInvalidValue;
  switch (D) {
    case 64: return launch_merge_d<T, 64>(a, stream);
    case 128: return launch_merge_d<T, 128>(a, stream);
    case 256: return launch_merge_d<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace llmss
