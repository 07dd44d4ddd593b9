// K1: causal flash attention for prefill, masked by positions.
//
// Replaces llmss_tpu/ops/pallas_attention.py::flash_attention (kernel body
// _kernel). Same function: out[b,s,h] = softmax over slots t of
// (q[b,s,h] . k[b,t,h/G]) * scale, restricted to slots with
// 0 <= kv_pos[b,t] <= q_pos[b,s] (and kv_pos > q_pos - window when a sliding
// window is set), times v. Scores and the running max / sum / accumulator
// are fp32; P is rounded to the value dtype before P.V, as in the Pallas
// kernel. Masked lanes use the finite fp32 minimum (see common.cuh); a row
// with no visible slot in any live tile ends as 0 (the l == 0 guard).
// q, k, v and out are read in their [B, S, H, D] layout through strides:
// no transposed copies.
//
// Two instantiations; the wrapper picks one from the dtype alone and this
// file refuses any other pairing:
//
// bf16 / f16 -> flash_mma, the tensor-core tile of attn_tile.cuh. One
// block per (64 flat query rows f = s*G + g, KV head, batch row), so the G
// query heads of a KV head share each K/V tile (GQA). What bounds it on
// the H100: at the engine's prefill shapes (S 128-512 in a ring of 1024
// slots, D = 128) a block does a few MFLOP against the K/V bytes of its
// live tiles, so bytes and launch latency bound it; for a long prompt
// against itself (S = T = 2048, causal) the S*T*D multiply-adds do, and
// mma.sync is then the limit short of wgmma. The design: K/V tiles
// double-buffered by cp.async, so the next live tile's copy overlaps this
// tile's products; tiles no row can see (empty ring slots, future
// positions, behind the window) are found from their positions before a
// copy is issued, so a mostly empty ring costs a read of its positions;
// Q.K^T and P.V on the tensor cores with fp32 accumulation. Rows must be
// 16-byte aligned (strides multiples of 8 elements); the wrapper checks.
//
// fp32 -> flash_fwd, fp32 FMAs from shared memory (the tensor cores would
// mean TF32, outside fp32's tolerance): one block per (64-row q tile, q
// head, batch row) over 64-slot KV tiles staged in shared memory, tiles
// no query can see skipped before they are loaded.
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
// l = 0, acc = 0: either weighs 0 once another chunk is visible. The
// state instantiations write the workspace where the others write the
// output; the others' code is unchanged.

#include "attn_tile.cuh"
#include "common.cuh"

#include <limits.h>

namespace llmss {
namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // KV slots per tile
constexpr int NT = 256;  // threads: 16 row groups x 16 column lanes
constexpr int PST = BK + 4;  // sP row stride (conflict-free writes)

template <typename T, int D>
struct Smem {
  static constexpr int PAD = 4 / sizeof(T);  // one 32-bit word per row
  static constexpr int LD = D + PAD;
  static constexpr size_t bytes =
      size_t(BQ + 2 * BK) * LD * sizeof(T) + size_t(BQ) * PST * sizeof(float) +
      size_t(BQ + BK) * sizeof(int);
};

template <typename T, int D, bool kState = false>
__global__ void __launch_bounds__(NT) flash_fwd(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, const int* __restrict__ qpos,
    const int* __restrict__ kvpos, int S, int Tn, int Hq, int Hkv,
    int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, int v_sb,
    int v_ss, int v_sh, int o_sb, int o_ss, int o_sh, float scale,
    int window) {
  constexpr int LD = Smem<T, D>::LD;
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + BQ * LD;
  T* sV = sK + BK * LD;
  float* sP = reinterpret_cast<float*>(sV + BK * LD);
  int* sQp = reinterpret_cast<int*>(sP + BQ * PST);
  int* sKp = sQp + BQ;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int r = tid / 16;  // row group: rows r*4 .. r*4+3
  const int c = tid % 16;  // column lane: slots c + 16*j, features c + 16*i

  const T* qb = q + (long long)b * q_sb + (long long)h * q_sh;
  const T* kb = k + (long long)b * k_sb + (long long)hk * k_sh;
  const T* vb = v + (long long)b * v_sb + (long long)hk * v_sh;

  for (int i = tid; i < BQ * D; i += NT) {
    const int row = i / D, d = i % D, s = q0 + row;
    sQ[row * LD + d] = s < S ? qb[(long long)s * q_ss + d] : from_f<T>(0.f);
  }
  for (int i = tid; i < BQ; i += NT)
    sQp[i] = (q0 + i < S) ? qpos[(long long)b * S + q0 + i] : -1;
  __syncthreads();

  // Block-skip bounds: the latest and earliest query of the tile.
  int qmax = INT_MIN, qmin = INT_MAX;
  const int nq = min(BQ, S - q0);
  for (int i = 0; i < nq; ++i) {
    qmax = max(qmax, sQp[i]);
    qmin = min(qmin, sQp[i]);
  }
  int qp_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qp_r[i] = sQp[r * 4 + i];

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DC; ++dd) acc[i][dd] = 0.f;
  }

  for (int k0 = 0; k0 < Tn; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    if (tid < BK)
      sKp[tid] = (k0 + tid < Tn) ? kvpos[(long long)b * Tn + k0 + tid] : -1;
    __syncthreads();
    // Uniform across the block: every thread reads the same positions.
    bool live = false;
    for (int j = 0; j < BK && !live; ++j) {
      const int p = sKp[j];
      live = p >= 0 && p <= qmax && (window <= 0 || p > qmin - window);
    }
    if (!live) continue;

    for (int i = tid; i < BK * D; i += NT) {
      const int row = i / D, d = i % D, t = k0 + row;
      const bool in = t < Tn;
      sK[row * LD + d] = in ? kb[(long long)t * k_ss + d] : from_f<T>(0.f);
      sV[row * LD + d] = in ? vb[(long long)t * v_ss + d] : from_f<T>(0.f);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = to_f<T>(sQ[(r * 4 + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = to_f<T>(sK[(c + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rowmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = sKp[c + 16 * j];
        const bool ok = p >= 0 && p <= qp_r[i] &&
                        (window <= 0 || p > qp_r[i] - window);
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        rowmax = fmaxf(rowmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rowmax = fmaxf(rowmax, __shfl_xor_sync(0xffffffffu, rowmax, off));
      const float m_next = fmaxf(m[i], rowmax);
      const float alpha = expf(m[i] - m_next);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_next);
        psum += p;
        sP[(r * 4 + i) * PST + c + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = alpha * l[i] + psum;
      m[i] = m_next;
#pragma unroll
      for (int dd = 0; dd < DC; ++dd) acc[i][dd] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float vv[DC];
#pragma unroll
      for (int dd = 0; dd < DC; ++dd) vv[dd] = to_f<T>(sV[j * LD + c + 16 * dd]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pj = sP[(r * 4 + i) * PST + j];
#pragma unroll
        for (int dd = 0; dd < DC; ++dd) acc[i][dd] = fmaf(pj, vv[dd], acc[i][dd]);
      }
    }
  }

  if constexpr (kState) {
    // o is the state workspace (the file's header has its layout).
    float* ws = reinterpret_cast<float*>(o);
    const int G = Hq / Hkv;
    const long long n_part = (long long)gridDim.z * S * Hq;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s_row = q0 + r * 4 + i;
      if (s_row >= S) continue;
      const long long row =
          (((long long)b * Hkv + hk) * S + s_row) * G + h % G;
#pragma unroll
      for (int dd = 0; dd < DC; ++dd) ws[row * D + c + 16 * dd] = acc[i][dd];
      if (c == 0) {
        ws[n_part * D + row] = m[i];
        ws[n_part * D + n_part + row] = l[i];
      }
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s_row = q0 + r * 4 + i;
    if (s_row >= S) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + (long long)b * o_sb + (long long)s_row * o_ss +
              (long long)h * o_sh;
#pragma unroll
    for (int dd = 0; dd < DC; ++dd)
      orow[c + 16 * dd] = from_f<T>(acc[i][dd] / l_safe);
  }
}

template <typename T, int D, bool kState>
cudaError_t launch(void* q, void* k, void* v, void* o, const int* qpos,
                   const int* kvpos, int B, int S, int Tn, int Hq, int Hkv,
                   const int* st, float scale, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = Smem<T, D>::bytes;
  auto kern = flash_fwd<T, D, kState>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qpos, kvpos, S, Tn, Hq,
      Hkv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], scale, window);
  return cudaGetLastError();
}

template <typename T, bool kState = false>
cudaError_t dispatch_d(int D, void* q, void* k, void* v, void* o,
                       const int* qpos, const int* kvpos, int B, int S,
                       int Tn, int Hq, int Hkv, const int* st, float scale,
                       int window, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64, kState>(q, k, v, o, qpos, kvpos, B, S, Tn, Hq,
                                   Hkv, st, scale, window, stream);
    case 128:
      return launch<T, 128, kState>(q, k, v, o, qpos, kvpos, B, S, Tn, Hq,
                                    Hkv, st, scale, window, stream);
    case 256:
      return launch<T, 256, kState>(q, k, v, o, qpos, kvpos, B, S, Tn, Hq,
                                    Hkv, st, scale, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// -- bf16 / f16: the tensor-core tile --------------------------------------

struct MmaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* qpos;   // [B, S]
  const int* kvpos;  // [B, T]
  int S, Tn, Hq, Hkv;
  int st[12];  // element strides (batch, seq, head) of q, k, v, out
  float scale;
  int window;
};

// tile::attend's Source for one block: flat rows f0 .. f0+63 of batch row
// b and KV head hk over the slots [0, Tn) of k / v.
template <typename T>
struct FlashSrc {
  const T *q, *k, *v;
  T* o;
  const int *qpos, *kvpos;  // row b's
  int Tn, G, hk, f0, nrows;
  long long q_ss, q_sh, k_ss, v_ss, o_ss, o_sh;
  int n_tiles, qmax, qmin, window;
  float scale_log2;

  __device__ bool has(int r) const { return f0 + r < nrows; }
  __device__ long long q_off(int r, long long ss, long long sh) const {
    const int f = f0 + r;
    return (long long)(f / G) * ss + (long long)(hk * G + f % G) * sh;
  }
  __device__ const T* q_row(int r) const {
    return has(r) ? q + q_off(r, q_ss, q_sh) : nullptr;
  }
  __device__ int q_pos(int r) const {
    return has(r) ? qpos[(f0 + r) / G] : -1;
  }
  __device__ T* o_row(int r) const {
    return has(r) ? o + q_off(r, o_ss, o_sh) : nullptr;
  }
  __device__ int slot_pos(int t, int j) const {
    const int x = t * tile::kSlots + j;
    return x < Tn ? kvpos[x] : -1;
  }
  __device__ bool rows(int t, int j, const T*& kr, const T*& vr) const {
    const int x = t * tile::kSlots + j;
    if (x >= Tn) return false;
    kr = k + x * k_ss;
    vr = v + x * v_ss;
    return true;
  }
  __device__ const T* any_ptr() const { return k; }
};

template <typename T, int D, bool kState = false>
__global__ void __launch_bounds__(tile::kThreads) flash_mma(MmaArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.z, hk = blockIdx.y;
  std::conditional_t<kState, tile::WithPartial<FlashSrc<T>>, FlashSrc<T>> s;
  s.G = a.Hq / a.Hkv;
  s.hk = hk;
  s.Tn = a.Tn;
  s.f0 = blockIdx.x * tile::kRows;
  s.nrows = a.S * s.G;
  s.q = static_cast<const T*>(a.q) + (long long)b * a.st[0];
  s.k = static_cast<const T*>(a.k) + (long long)b * a.st[3] + (long long)hk * a.st[5];
  s.v = static_cast<const T*>(a.v) + (long long)b * a.st[6] + (long long)hk * a.st[8];
  s.o = static_cast<T*>(a.o) + (long long)b * a.st[9];
  s.q_ss = a.st[1];
  s.q_sh = a.st[2];
  s.k_ss = a.st[4];
  s.v_ss = a.st[7];
  s.o_ss = a.st[10];
  s.o_sh = a.st[11];
  s.qpos = a.qpos + (long long)b * a.S;
  s.kvpos = a.kvpos + (long long)b * a.Tn;
  s.n_tiles = (a.Tn + tile::kSlots - 1) / tile::kSlots;
  s.window = a.window;
  s.scale_log2 = a.scale * 1.4426950408889634f;
  // Tile-skip bounds: the latest and earliest query of the block (every
  // warp reduces the same values).
  int hi = INT_MIN, lo = INT_MAX;
  for (int r = threadIdx.x % 32; r < tile::kRows; r += 32) {
    if (!s.has(r)) continue;
    const int p = s.q_pos(r);
    hi = max(hi, p);
    lo = min(lo, p);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
  }
  s.qmax = hi;
  s.qmin = lo;
  if constexpr (kState) {
    // a.o is the state workspace: flat row f of (b, hk) is state row
    // (b * Hkv + hk) * S * G + f, so the block's rows are consecutive.
    s.part = {static_cast<float*>(a.o), (long long)gridDim.z * a.S * a.Hq,
              ((long long)b * a.Hkv + hk) * s.nrows + s.f0, 1,
              min(tile::kRows, s.nrows - s.f0)};
  }
  tile::attend<T, D, false>(s, smem);
}

template <typename T, int D, bool kState>
cudaError_t launch_mma(const MmaArgs& a, int B, cudaStream_t stream) {
  constexpr size_t smem = tile::Smem<D>::bytes;
  auto kern = flash_mma<T, D, kState>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int G = a.Hq / a.Hkv;
  dim3 grid((a.S * G + tile::kRows - 1) / tile::kRows, a.Hkv, B);
  kern<<<grid, tile::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kState = false>
cudaError_t dispatch_mma(int D, const MmaArgs& a, int B, cudaStream_t s) {
  switch (D) {
    case 64: return launch_mma<T, 64, kState>(a, B, s);
    case 128: return launch_mma<T, 128, kState>(a, B, s);
    case 256: return launch_mma<T, 256, kState>(a, B, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace llmss

// strides: 12 element strides (batch, seq, head) for q, k, v, out in that
// order; the feature dim must be contiguous. impl: 0 = flash_fwd (fp32
// only), 1 = flash_mma (bf16 / f16 only; strides multiples of 8, pointers
// 16-byte aligned). window <= 0 means full causal. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int llmss_flash_attention(void* q, void* k, void* v, void* o,
                                     void* qpos, void* kvpos, void* strides,
                                     int B, int S, int T, int Hq, int Hkv,
                                     int D, int dtype, int impl, float scale,
                                     int window, void* stream) {
  using namespace llmss;
  if (B == 0 || S == 0) return 0;
  const int* st = static_cast<const int*>(strides);
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kvpos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (impl == 0 && dtype == kF32) {
    err = dispatch_d<float>(D, q, k, v, o, qp, kp, B, S, T, Hq, Hkv, st,
                            scale, window, s);
  } else if (impl == 1 && (dtype == kBF16 || dtype == kF16)) {
    MmaArgs a{q, k, v, o, qp, kp, S, T, Hq, Hkv, {}, scale, window};
    for (int i = 0; i < 12; ++i) a.st[i] = st[i];
    err = dtype == kBF16 ? dispatch_mma<__nv_bfloat16>(D, a, B, s)
                         : dispatch_mma<__half>(D, a, B, s);
  }
  return static_cast<int>(err);
}

// The state-out form of llmss_flash_attention (kState): the same
// arguments, with ws (fp32, B*S*Hq*(D + 2) floats, the header's layout)
// in the place of the output and its strides (st[9..11]) unused.
extern "C" int llmss_flash_attention_state(void* q, void* k, void* v,
                                           void* ws, void* qpos, void* kvpos,
                                           void* strides, int B, int S, int T,
                                           int Hq, int Hkv, int D, int dtype,
                                           int impl, float scale, int window,
                                           void* stream) {
  using namespace llmss;
  if (B == 0 || S == 0) return 0;
  const int* st = static_cast<const int*>(strides);
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kvpos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (impl == 0 && dtype == kF32) {
    err = dispatch_d<float, true>(D, q, k, v, ws, qp, kp, B, S, T, Hq, Hkv,
                                  st, scale, window, s);
  } else if (impl == 1 && (dtype == kBF16 || dtype == kF16)) {
    MmaArgs a{q, k, v, ws, qp, kp, S, T, Hq, Hkv, {}, scale, window};
    for (int i = 0; i < 12; ++i) a.st[i] = st[i];
    err = dtype == kBF16 ? dispatch_mma<__nv_bfloat16, true>(D, a, B, s)
                         : dispatch_mma<__half, true>(D, a, B, s);
  }
  return static_cast<int>(err);
}
