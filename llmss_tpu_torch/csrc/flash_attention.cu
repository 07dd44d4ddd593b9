// K1: causal flash attention for prefill, masked by positions.
//
// Replaces llmss_tpu/ops/pallas_attention.py::flash_attention (kernel body
// _kernel). Same function: out[b,s,h] = softmax over slots t of
// (q[b,s,h] . k[b,t,h/G]) * scale, restricted to slots with
// 0 <= kv_pos[b,t] <= q_pos[b,s] (and kv_pos > q_pos - window when a sliding
// window is set), times v. Scores and the running max / sum / accumulator
// are fp32; P is rounded to the value dtype before P.V, as in the Pallas
// kernel. Masked lanes use the finite fp32 minimum (see common.cuh); a row
// with no visible slot ends as the uniform average of the slots of the
// tiles its block found live (so it depends on the tile width: 128 slots
// at D 64 / 128 and 64 at D 256 for bf16 / f16, BK below for fp32), or as
// 0 if no tile is live (the l == 0 guard). No prefill row is such a row: a
// prompt row sees its own key. q, k, v and out are read in their
// [B, S, H, D] layout through strides: no transposed copies; every stride
// must be a multiple of 16 bytes and every base 16-byte aligned (the
// wrapper checks).
//
// Two instantiations; the wrapper picks one from the dtype alone and this
// file refuses any other pairing:
//
// bf16 / f16 -> flash_wgmma, a Hopper tile (hopper.cuh). One block per
// (KV head, batch row, 128 flat query rows f = s*G + g; 64 where 128-row
// blocks would leave half the SMs idle or be half empty, the host's rule),
// so the G query
// heads of a KV head share every K/V byte (GQA). What bounds it on the
// H100: a long prompt against itself (S = T = 2048) is bound by its
// S*T*D multiply-adds, which only wgmma runs at the tensor cores' full
// rate; the engine's prefill (128-token prompts in a 1,024-slot ring)
// by the latency of a block's few loads and one live tile. The design:
//   * warpgroup 0 is the producer: one warp reads the positions of the
//     K/V tiles (four tiles at a time), classifies each and, for a live
//     one, waits for a free stage, writes the tile's class and positions
//     there and issues its K and V boxes by TMA (4-D maps over the strided
//     [B, T, Hkv, D] views; rows past T land as zeros) onto the stage's
//     full barrier. Its warpgroup gives its registers to the consumers
//     (setmaxnreg). Only the producer probes positions.
//   * tile classes, from the block's earliest and latest query position
//     qmin / qmax: skipped (no row sees a slot: never copied), full
//     (every slot 0 <= p <= qmin and, with a window, p > qmax - window:
//     every row sees every slot, no per-element mask), masked (the rest).
//     At S = T = 2048 all but the 16 diagonal tiles a head are full.
//   * warpgroup 1 (and 2, at 128 rows) are the consumers, 64 rows each.
//     Q is loaded
//     once by their threads into the swizzled layout wgmma reads (flat
//     rows at G = 48 or 4 form no TMA box). Per tile: S = Q.K^T by wgmma
//     from shared memory (K-major), mask (masked tiles only), online
//     softmax in registers, P rounded to the value dtype in registers as
//     the A operand of O += P.V by wgmma, V read MN-major (the transpose
//     bit: no transposed copy); the row sum uses the unrounded P. Then
//     each consumer warp releases the stage on its empty barrier.
//   * a ring of 3 stages at D 64, 2 at D 128 / 256 (tiles of 128 slots,
//     64 at D 256, so O (64 x D fp32) and S fit a consumer's registers).
//   * query tiles run heaviest first: block z takes the last query tile
//     first, so the longest causal walks start in the first wave.
//
// fp32 -> flash_fwd, fp32 FMAs from shared memory (the tensor cores would
// mean TF32, outside fp32's tolerance): one block per (BQ query rows, q
// head, batch row) over BK-slot KV tiles staged in shared memory, tiles
// no query can see skipped before they are loaded. The host sizes BQ (16,
// 32 or 64; ops/flash_attention.py::fma_rows) to the grid: the most rows
// a block whose B * Hq * ceil(S / BQ) blocks still give every SM one, else
// 16; BK is 32 at D 256 (two blocks an SM), else 64. Rows are read as
// float4: strides multiples of 4 floats.
//
// State-out (kState, a compile-time flag; llmss_flash_attention_state):
// the same two kernels over one KV chunk, leaving each (query row, head)'s
// fp32 softmax state instead of its output: the unnormalised accumulator
// acc, the running max m (natural-log units of the scaled scores) and the
// sum l, in a workspace [B, Hkv, S, G] (acc with D more floats a row; m
// then l after the n = B*S*Hq accumulators). The sequence-parallel ring
// prefill (ops/ring_attention.py) merges the chunks' states after each
// hop, as the reference's _online_block carries them. A row that sees
// nothing in the chunk keeps m = kNegInf (its l counts the live tiles'
// slots, the finite-min semantics), and a block with no live tile leaves
// l = 0, acc = 0: either weighs 0 once another chunk is visible.

#include "common.cuh"
#include "hopper.cuh"

#include <limits.h>

namespace llmss {
namespace {

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;           // the output, or the state workspace (kState)
  const int* qpos;   // [B, S]
  const int* kvpos;  // [B, T]
  int S, Tn, Hq, Hkv;
  int st[12];  // element strides (batch, seq, head) of q, k, v, out
  float scale;
  int window;
};

__device__ __forceinline__ bool sees(int p, int q, int window) {
  return p >= 0 && p <= q && (window <= 0 || p > q - window);
}

// -- fp32: FMAs ---------------------------------------------------------------

constexpr int kFmaThreads = 256;  // 16 row groups x 16 column lanes

// KV slots a tile of flash_fwd: 32 at D 256, so two blocks fit an SM.
constexpr int fma_slots(int D) { return D > 128 ? 32 : 64; }

// Shared memory of flash_fwd<D, BQ, BK>: Q [BQ][D + 4] and K, V [BK][D + 4]
// (rows 16-byte aligned for float4 reads), P [BQ][BK + 4], the rows' and
// the tile's positions. Mirrored by ops/flash_attention.py::fma_smem_bytes.
template <int D, int BQ, int BK> struct FmaSmem {
  static constexpr int LD = D + 4;
  static constexpr int PST = BK + 4;
  static constexpr size_t bytes =
      4 * (size_t(BQ + 2 * BK) * LD + size_t(BQ) * PST + BQ + BK);
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// Thread (r, c) holds rows r * RPT + i and slots c + 16 * j of the tile,
// and output features 4c + 64 * cv + e.
template <int D, int BQ, int BK, bool kState>
__global__ void __launch_bounds__(kFmaThreads)
    flash_fwd(const __grid_constant__ Args a) {
  using SM = FmaSmem<D, BQ, BK>;
  constexpr int LD = SM::LD, PST = SM::PST;
  constexpr int RPT = BQ / 16, SPT = BK / 16, CV = D / 64;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;
  int* sQp = reinterpret_cast<int*>(sP + BQ * PST);
  int* sKp = sQp + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int S = a.S, Tn = a.Tn, window = a.window;
  const int hk = h / (a.Hq / a.Hkv);
  const int tid = threadIdx.x;
  const int r = tid / 16;
  const int c = tid % 16;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  const float* qb = static_cast<const float*>(a.q) + (long long)b * a.st[0] +
                    (long long)h * a.st[2];
  const float* kb = static_cast<const float*>(a.k) + (long long)b * a.st[3] +
                    (long long)hk * a.st[5];
  const float* vb = static_cast<const float*>(a.v) + (long long)b * a.st[6] +
                    (long long)hk * a.st[8];

  for (int i = tid; i < BQ * D / 4; i += kFmaThreads) {
    const int row = i / (D / 4), d = 4 * (i % (D / 4)), s = q0 + row;
    *reinterpret_cast<float4*>(sQ + row * LD + d) =
        s < S ? ld4(qb + (long long)s * a.st[1] + d) : zero;
  }
  for (int i = tid; i < BQ; i += kFmaThreads)
    sQp[i] = (q0 + i < S) ? a.qpos[(long long)b * S + q0 + i] : -1;
  __syncthreads();

  // Block-skip bounds: the latest and earliest query of the tile.
  int qmax = INT_MIN, qmin = INT_MAX;
  const int nq = min(BQ, S - q0);
  for (int i = 0; i < nq; ++i) {
    qmax = max(qmax, sQp[i]);
    qmin = min(qmin, sQp[i]);
  }
  int qp_r[RPT];
  float m[RPT], l[RPT], acc[RPT][CV][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    qp_r[i] = sQp[r * RPT + i];
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int cv = 0; cv < CV; ++cv)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][cv][e] = 0.f;
  }

  for (int k0 = 0; k0 < Tn; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    bool mine = false;
    if (tid < BK) {
      const int p = k0 + tid < Tn ? a.kvpos[(long long)b * Tn + k0 + tid] : -1;
      sKp[tid] = p;
      mine = p >= 0 && p <= qmax && (window <= 0 || p > qmin - window);
    }
    if (!__syncthreads_or(mine)) continue;  // no query of the block sees it

#pragma unroll 4
    for (int i = tid; i < BK * D / 4; i += kFmaThreads) {
      const int row = i / (D / 4), d = 4 * (i % (D / 4)), t = k0 + row;
      const bool in = t < Tn;
      *reinterpret_cast<float4*>(sK + row * LD + d) =
          in ? ld4(kb + (long long)t * a.st[4] + d) : zero;
      *reinterpret_cast<float4*>(sV + row * LD + d) =
          in ? ld4(vb + (long long)t * a.st[7] + d) : zero;
    }
    __syncthreads();

    float s[RPT][SPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < SPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[RPT], kv[SPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (r * RPT + i) * LD + d);
#pragma unroll
      for (int j = 0; j < SPT; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (c + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < SPT; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float rowmax = kNegInf;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        s[i][j] = sees(sKp[c + 16 * j], qp_r[i], window) ? s[i][j] * a.scale
                                                         : kNegInf;
        rowmax = fmaxf(rowmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rowmax = fmaxf(rowmax, __shfl_xor_sync(0xffffffffu, rowmax, off));
      const float m_next = fmaxf(m[i], rowmax);
      const float alpha = expf(m[i] - m_next);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const float p = expf(s[i][j] - m_next);
        psum += p;
        sP[(r * RPT + i) * PST + c + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = alpha * l[i] + psum;
      m[i] = m_next;
#pragma unroll
      for (int cv = 0; cv < CV; ++cv)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][cv][e] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float4 vv[CV];
#pragma unroll
      for (int cv = 0; cv < CV; ++cv)
        vv[cv] = *reinterpret_cast<const float4*>(sV + j * LD + 4 * c + 64 * cv);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float pj = sP[(r * RPT + i) * PST + j];
#pragma unroll
        for (int cv = 0; cv < CV; ++cv) {
          acc[i][cv][0] = fmaf(pj, vv[cv].x, acc[i][cv][0]);
          acc[i][cv][1] = fmaf(pj, vv[cv].y, acc[i][cv][1]);
          acc[i][cv][2] = fmaf(pj, vv[cv].z, acc[i][cv][2]);
          acc[i][cv][3] = fmaf(pj, vv[cv].w, acc[i][cv][3]);
        }
      }
    }
  }

  if constexpr (kState) {
    // a.o is the state workspace (the file's header has its layout).
    float* ws = static_cast<float*>(a.o);
    const int G = a.Hq / a.Hkv;
    const long long n_part = (long long)gridDim.z * S * a.Hq;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int s_row = q0 + r * RPT + i;
      if (s_row >= S) continue;
      const long long row =
          (((long long)b * a.Hkv + hk) * S + s_row) * G + h % G;
#pragma unroll
      for (int cv = 0; cv < CV; ++cv)
        *reinterpret_cast<float4*>(ws + row * D + 4 * c + 64 * cv) = make_float4(
            acc[i][cv][0], acc[i][cv][1], acc[i][cv][2], acc[i][cv][3]);
      if (c == 0) {
        ws[n_part * D + row] = m[i];
        ws[n_part * D + n_part + row] = l[i];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int s_row = q0 + r * RPT + i;
      if (s_row >= S) continue;
      const float l_safe = l[i] == 0.f ? 1.f : l[i];
      float* orow = static_cast<float*>(a.o) + (long long)b * a.st[9] +
                    (long long)s_row * a.st[10] + (long long)h * a.st[11];
#pragma unroll
      for (int cv = 0; cv < CV; ++cv)
        *reinterpret_cast<float4*>(orow + 4 * c + 64 * cv) =
            make_float4(acc[i][cv][0] / l_safe, acc[i][cv][1] / l_safe,
                        acc[i][cv][2] / l_safe, acc[i][cv][3] / l_safe);
    }
  }
}

template <int D, int BQ, bool kState>
cudaError_t launch_fma(const Args& a, int B, cudaStream_t stream) {
  constexpr int BK = fma_slots(D);
  constexpr size_t smem = FmaSmem<D, BQ, BK>::bytes;
  auto kern = flash_fwd<D, BQ, BK, kState>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + BQ - 1) / BQ, a.Hq, B);
  kern<<<grid, kFmaThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// rows: the host's BQ (ops/flash_attention.py::fma_rows): 16, 32 or 64,
// at most 32 at D 256.
template <int D, bool kState>
cudaError_t dispatch_rows(const Args& a, int B, int rows, cudaStream_t s) {
  if (rows == 16) return launch_fma<D, 16, kState>(a, B, s);
  if (rows == 32) return launch_fma<D, 32, kState>(a, B, s);
  if constexpr (D <= 128) {
    if (rows == 64) return launch_fma<D, 64, kState>(a, B, s);
  }
  return cudaErrorInvalidValue;
}

template <bool kState>
cudaError_t dispatch_fma(const Args& a, int B, int D, int rows,
                         cudaStream_t s) {
  switch (D) {
    case 64: return dispatch_rows<64, kState>(a, B, rows, s);
    case 128: return dispatch_rows<128, kState>(a, B, rows, s);
    case 256: return dispatch_rows<256, kState>(a, B, rows, s);
    default: return cudaErrorInvalidValue;
  }
}

// -- bf16 / f16: the wgmma tile -----------------------------------------------

namespace wg {

// A block is warpgroup 0, the producer, and NC (1 or 2) consumer
// warpgroups of 64 flat query rows each: 128 rows a block where the grid
// fills the card, 64 where it would leave SMs idle (the host's rule,
// ops/flash_attention.py::wgmma_rows). Every form is compiled for 384
// threads, so its registers at entry (168) are the same and the
// setmaxnreg pair below is valid at either size.
constexpr int kMaxThreads = 384;
constexpr int kLook = 4;       // tiles whose positions the producer loads at once
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// The block's shared memory, from a 1024-byte aligned base: Q [NB boxes]
// [ROWS][64] | stages x (K [NB][BK][64], V [NB][BK][64]) | positions
// [STAGES][BK] | tile index [STAGES] (-1: no more tiles), tile class
// [STAGES] (1: full) | full [STAGES], empty [STAGES] barriers; 1024 bytes
// of slack to align the base. Mirrored by ops/flash_attention.py::
// wgmma_smem_bytes.
template <int D, int NC> struct Plan {
  static constexpr int ROWS = 64 * NC;  // flat query rows a block
  static constexpr int BK = D <= 128 ? 128 : 64;  // KV slots a tile
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr int NB = D / 64;  // 64-feature boxes a row
  static constexpr int Q_BYTES = ROWS * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one K or one V tile
  static constexpr int POS_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int INFO_OFF = POS_OFF + STAGES * BK * 4;
  static constexpr int BAR_OFF = INFO_OFF + STAGES * 8;
  static constexpr size_t bytes = 1024 + BAR_OFF + STAGES * 16;
};

template <int D, int NC> struct Ring {
  unsigned char* base;  // Q, then the stages
  int* pos;
  int* tile;
  int* full_tile;
  uint64_t* full;
  uint64_t* empty;
  __device__ unsigned char* k(int stage) const {
    return base + Plan<D, NC>::Q_BYTES + stage * 2 * Plan<D, NC>::KV_BYTES;
  }
  __device__ unsigned char* v(int stage) const {
    return k(stage) + Plan<D, NC>::KV_BYTES;
  }
};

// The producer warp: classify every KV tile from its positions and, for
// each live one, fill the next free stage (its class, positions, and K and
// V by TMA); then mark the stage after the last with tile -1.
template <int D, int NC>
__device__ __forceinline__ void produce(const CUtensorMap* kmap,
                                        const CUtensorMap* vmap,
                                        const Args& a, const Ring<D, NC>& ring,
                                        int b, int hk, int f0) {
  using P = Plan<D, NC>;
  constexpr int BK = P::BK, PER = BK / 32;
  const int lane = threadIdx.x % 32;
  const int G = a.Hq / a.Hkv, nrows = a.S * G, window = a.window;
  const int* qpos = a.qpos + (long long)b * a.S;
  const int* kvpos = a.kvpos + (long long)b * a.Tn;
  if (lane == 0) {
    hop::prefetch_map(kmap);
    hop::prefetch_map(vmap);
  }
  int lo = INT_MAX, hi = INT_MIN;  // the block's earliest and latest query
  for (int r = lane; r < P::ROWS; r += 32) {
    const int f = f0 + r;
    if (f < nrows) {
      const int p = qpos[f / G];
      lo = min(lo, p);
      hi = max(hi, p);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  const int n_tiles = (a.Tn + BK - 1) / BK;
  int stage = 0;
  uint32_t phase = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += kLook) {
    int p[kLook][PER];
#pragma unroll
    for (int u = 0; u < kLook; ++u)
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int x = (t0 + u) * BK + lane + 32 * i;
        p[u][i] = x < a.Tn ? kvpos[x] : -1;
      }
#pragma unroll
    for (int u = 0; u < kLook; ++u) {
      bool live = false, all = true;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int x = p[u][i];
        live |= x >= 0 && x <= hi && (window <= 0 || x > lo - window);
        all &= x >= 0 && x <= lo && (window <= 0 || x > hi - window);
      }
      if (!__any_sync(0xffffffffu, live)) continue;  // skipped: never copied
      const bool full_tile = __all_sync(0xffffffffu, all);
      hop::mbar_wait(&ring.empty[stage], phase ^ 1);
#pragma unroll
      for (int i = 0; i < PER; ++i) ring.pos[stage * BK + lane + 32 * i] = p[u][i];
      if (lane == 0) {
        const int t = t0 + u;
        ring.tile[stage] = t;
        ring.full_tile[stage] = full_tile;
        hop::mbar_arrive_expect_tx(&ring.full[stage], 2 * P::KV_BYTES);
#pragma unroll
        for (int x = 0; x < P::NB; ++x) {
          hop::tma_load_4d(ring.k(stage) + x * BK * 128, kmap, &ring.full[stage],
                           64 * x, hk, t * BK, b);
          hop::tma_load_4d(ring.v(stage) + x * BK * 128, vmap, &ring.full[stage],
                           64 * x, hk, t * BK, b);
        }
      } else {
        hop::mbar_arrive(&ring.full[stage]);
      }
      if (++stage == P::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  hop::mbar_wait(&ring.empty[stage], phase ^ 1);
  if (lane == 0) ring.tile[stage] = -1;
  hop::mbar_arrive(&ring.full[stage]);
}

// A consumer warpgroup: rows 64 * c .. 64 * c + 63 of the block. Thread t
// of the warpgroup holds rows 16 * (t / 32) + (t % 32) / 4 and that + 8.
template <typename T, int D, int NC, bool kState>
__device__ __forceinline__ void consume(const Args& a, const Ring<D, NC>& ring,
                                        int b, int hk, int f0, int c) {
  using P = Plan<D, NC>;
  constexpr int BK = P::BK;
  const int tw = threadIdx.x % 128, lane = tw % 32, t4 = lane % 4;
  const int G = a.Hq / a.Hkv, nrows = a.S * G, window = a.window;
  unsigned char* q_sm = ring.base + c * 64 * 128;  // this warpgroup's rows

  // Q, once: 16-byte chunks into the 128-byte swizzle of each box.
  const T* qb = static_cast<const T*>(a.q) + (long long)b * a.st[0];
  for (int i = tw; i < 64 * (D / 8); i += 128) {
    const int r = i / (D / 8), ch = i % (D / 8), f = f0 + 64 * c + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (f < nrows)
      val = __ldg(reinterpret_cast<const uint4*>(
          qb + (long long)(f / G) * a.st[1] + (long long)(hk * G + f % G) * a.st[2] +
          ch * 8));
    *reinterpret_cast<uint4*>(q_sm + (ch / 8) * (P::ROWS * 128) +
                              hop::swizzled(r, ch % 8)) = val;
  }
  hop::fence_proxy_async();
  hop::named_sync(1 + c, 128);

  const int r0 = 64 * c + 16 * (tw / 32) + lane / 4;  // rows r0, r0 + 8
  int qp[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int f = f0 + r0 + 8 * rr;
    qp[rr] = f < nrows ? a.qpos[(long long)b * a.S + f / G] : -1;
  }
  const float sc = a.scale * 1.4426950408889634f;  // scores in log2 units
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[D / 2], s[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;

  int stage = 0;
  uint32_t phase = 0;
  for (;;) {
    hop::mbar_wait(&ring.full[stage], phase);
    if (ring.tile[stage] < 0) break;
    const unsigned char* kt = ring.k(stage);
    const unsigned char* vt = ring.v(stage);

    // S = Q K^T: 64 rows x BK slots, D / 16 steps of k16.
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int box = kk / 4, off = 32 * (kk % 4);
      hop::mma_ss<T, BK>(
          s, hop::desc_sw128(q_sm + box * P::ROWS * 128 + off, 0, 1024),
          hop::desc_sw128(kt + box * BK * 128 + off, 0, 1024), kk > 0);
    }
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(s);

    // Scale (log2 units), mask a masked tile, online softmax.
    if (ring.full_tile[stage]) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] *= sc;
    } else {
      const int* pos = ring.pos + stage * BK;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int2 pp = *reinterpret_cast<const int2*>(pos + 8 * j + 2 * t4);
        s[4 * j] = sees(pp.x, qp[0], window) ? s[4 * j] * sc : kNegInf;
        s[4 * j + 1] = sees(pp.y, qp[0], window) ? s[4 * j + 1] * sc : kNegInf;
        s[4 * j + 2] = sees(pp.x, qp[1], window) ? s[4 * j + 2] * sc : kNegInf;
        s[4 * j + 3] = sees(pp.y, qp[1], window) ? s[4 * j + 3] * sc : kNegInf;
      }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
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
    for (int i = 0; i < BK / 2; ++i) {
      s[i] = exp2f(s[i] - mx[(i / 2) % 2]);
      l[(i / 2) % 2] += s[i];
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];

    // O += P V: P rounded to T as four 16-slot A fragments a k16 step.
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = hop::pack2<T>(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hop::mma_rs<T, D>(o, pa[kk], hop::desc_sw128(vt + kk * 16 * 128, BK * 128, 1024),
                        1);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(o);

    __syncwarp();
    if (lane == 0) hop::mbar_arrive(&ring.empty[stage]);
    if (++stage == P::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int f = f0 + r0 + 8 * rr;
    if (f >= nrows) continue;
    if constexpr (kState) {
      // a.o is the state workspace: flat row f of (b, hk) is state row
      // (b * Hkv + hk) * S * G + f.
      float* ws = static_cast<float*>(a.o);
      const long long n_part = (long long)gridDim.y * a.S * a.Hq;
      const long long row = ((long long)b * a.Hkv + hk) * nrows + f;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(ws + row * D + 8 * j + 2 * t4) =
            make_float2(o[4 * j + 2 * rr], o[4 * j + 2 * rr + 1]);
      if (t4 == 0) {
        ws[n_part * D + row] =
            m[rr] == kNegInf ? kNegInf : m[rr] * 0.6931471805599453f;
        ws[n_part * D + n_part + row] = l[rr];
      }
    } else {
      T* orow = static_cast<T*>(a.o) + (long long)b * a.st[9] +
                (long long)(f / G) * a.st[10] + (long long)(hk * G + f % G) * a.st[11];
      const float inv = 1.f / (l[rr] == 0.f ? 1.f : l[rr]);  // nothing seen: 0
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j + 2 * t4) = hop::pack2<T>(
            o[4 * j + 2 * rr] * inv, o[4 * j + 2 * rr + 1] * inv);
    }
  }
}

}  // namespace wg

template <typename T, int D, int NC, bool kState>
__global__ void __launch_bounds__(wg::kMaxThreads, 1)
    flash_wgmma(const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ Args a) {
  using P = wg::Plan<D, NC>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023)) & 1023);
  const wg::Ring<D, NC> ring{
      base,
      reinterpret_cast<int*>(base + P::POS_OFF),
      reinterpret_cast<int*>(base + P::INFO_OFF),
      reinterpret_cast<int*>(base + P::INFO_OFF) + P::STAGES,
      reinterpret_cast<uint64_t*>(base + P::BAR_OFF),
      reinterpret_cast<uint64_t*>(base + P::BAR_OFF) + P::STAGES};
  const int hk = blockIdx.x, b = blockIdx.y;
  // Heaviest query tile first: the last flat rows walk the most KV tiles.
  const int f0 = (gridDim.z - 1 - blockIdx.z) * P::ROWS;
  if (threadIdx.x == 0) {
    for (int i = 0; i < P::STAGES; ++i) {
      hop::mbar_init(&ring.full[i], 32);  // the producer warp's lanes
      hop::mbar_init(&ring.empty[i], 4 * NC);  // the consumers' warps
    }
    hop::fence_barrier_init();
  }
  __syncthreads();
  const int warpgroup = threadIdx.x / 128;
  if (warpgroup == 0) {
    hop::setmaxnreg_dec<wg::kProducerRegs>();
    if (threadIdx.x < 32) wg::produce<D, NC>(&kmap, &vmap, a, ring, b, hk, f0);
  } else {
    hop::setmaxnreg_inc<wg::kConsumerRegs>();
    wg::consume<T, D, NC, kState>(a, ring, b, hk, f0, warpgroup - 1);
  }
}

template <typename T, int D, int NC, bool kState>
cudaError_t launch_wgmma(const Args& a, int B, cudaStream_t stream) {
  using P = wg::Plan<D, NC>;
  const int* st = a.st;
  // A map needs a T of at least one row; with none no tile is ever copied.
  const int Tn = a.Tn > 0 ? a.Tn : 1;
  CUtensorMap kmap, vmap;
  cudaError_t err = hop::encode_rows<T>(&kmap, a.k, B, Tn, a.Hkv, D, st[3],
                                        st[4], st[5], P::BK);
  if (err != cudaSuccess) return err;
  err = hop::encode_rows<T>(&vmap, a.v, B, Tn, a.Hkv, D, st[6], st[7], st[8],
                            P::BK);
  if (err != cudaSuccess) return err;
  auto kern = flash_wgmma<T, D, NC, kState>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)P::bytes);
  if (err != cudaSuccess) return err;
  const int n_qt = (a.S * (a.Hq / a.Hkv) + P::ROWS - 1) / P::ROWS;
  dim3 grid(a.Hkv, B, n_qt);
  kern<<<grid, 128 * (NC + 1), P::bytes, stream>>>(kmap, vmap, a);
  return cudaGetLastError();
}

template <typename T, int NC, bool kState>
cudaError_t dispatch_d(const Args& a, int B, int D, cudaStream_t s) {
  switch (D) {
    case 64: return launch_wgmma<T, 64, NC, kState>(a, B, s);
    case 128: return launch_wgmma<T, 128, NC, kState>(a, B, s);
    case 256: return launch_wgmma<T, 256, NC, kState>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

// rows: the host's flat query rows a block (ops/flash_attention.py::
// wgmma_rows), 64 or 128.
template <typename T, bool kState>
cudaError_t dispatch_wgmma(const Args& a, int B, int D, int rows,
                           cudaStream_t s) {
  if (rows == 128) return dispatch_d<T, 2, kState>(a, B, D, s);
  if (rows == 64) return dispatch_d<T, 1, kState>(a, B, D, s);
  return cudaErrorInvalidValue;
}

template <bool kState>
int run(void* q, void* k, void* v, void* o, void* qpos, void* kvpos,
        void* strides, int B, int S, int T, int Hq, int Hkv, int D, int dtype,
        int impl, int rows, float scale, int window, void* stream) {
  if (B == 0 || S == 0) return 0;
  Args a{q, k, v, o, static_cast<const int*>(qpos),
         static_cast<const int*>(kvpos), S, T, Hq, Hkv, {}, scale, window};
  const int* st = static_cast<const int*>(strides);
  for (int i = 0; i < 12; ++i) a.st[i] = st[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (impl == 0 && dtype == kF32) {
    err = dispatch_fma<kState>(a, B, D, rows, s);
  } else if (impl == 4 && dtype == kBF16) {
    err = dispatch_wgmma<__nv_bfloat16, kState>(a, B, D, rows, s);
  } else if (impl == 4 && dtype == kF16) {
    if constexpr (!kState) err = dispatch_wgmma<__half, false>(a, B, D, rows, s);
  }
  return static_cast<int>(err);
}

}  // namespace
}  // namespace llmss

// strides: 12 element strides (batch, seq, head) for q, k, v, out in that
// order; the feature dim must be contiguous, every stride a multiple of
// 16 bytes and every pointer 16-byte aligned. impl: 0 = flash_fwd (fp32
// only; rows = its query rows a block, 16, 32 or 64, at most 32 at D 256),
// 4 = flash_wgmma (bf16 / f16; rows = its flat query rows a block, 64 or
// 128). window <= 0 means full causal.
// Returns cudaGetLastError() after the launch (0 on success), or the
// error of encoding the K / V tensor maps.
extern "C" int llmss_flash_attention(void* q, void* k, void* v, void* o,
                                     void* qpos, void* kvpos, void* strides,
                                     int B, int S, int T, int Hq, int Hkv,
                                     int D, int dtype, int impl, int rows,
                                     float scale, int window, void* stream) {
  return llmss::run<false>(q, k, v, o, qpos, kvpos, strides, B, S, T, Hq, Hkv,
                           D, dtype, impl, rows, scale, window, stream);
}

// The state-out form of llmss_flash_attention (kState): the same
// arguments, with ws (fp32, B*S*Hq*(D + 2) floats, the header's layout)
// in the place of the output and its strides (st[9..11]) unused; bf16 or
// fp32.
extern "C" int llmss_flash_attention_state(void* q, void* k, void* v,
                                           void* ws, void* qpos, void* kvpos,
                                           void* strides, int B, int S, int T,
                                           int Hq, int Hkv, int D, int dtype,
                                           int impl, int rows, float scale,
                                           int window, void* stream) {
  return llmss::run<true>(q, k, v, ws, qpos, kvpos, strides, B, S, T, Hq, Hkv,
                          D, dtype, impl, rows, scale, window, stream);
}
