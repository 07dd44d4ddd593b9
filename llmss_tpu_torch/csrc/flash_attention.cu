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
//
// What bounds it on the H100: at prefill shapes (S and T in the hundreds to
// thousands, D = 128) the work is O(S*T*D) multiply-adds against O((S+T)*D)
// bytes, so it is bound by arithmetic. This first version does that
// arithmetic with plain fp32 FMAs from shared memory (no tensor cores; wgmma
// and TMA are later work), so it runs far below the 989 TFLOP/s bf16 peak.
// What the design does about it:
//   * one block per (q tile of 64 rows, q head, batch row), so the grid has
//     thousands of blocks to spread over 132 SMs;
//   * a loop over 64-slot KV tiles staged in shared memory replaces the
//     TPU's sequential grid axis; each K/V element loaded is reused by the
//     64 query rows of the tile;
//   * KV tiles that no query row of the tile can see (empty slots, -1,
//     future positions, or slots behind the window) are skipped before they
//     are loaded, so a long, mostly empty ring costs little;
//   * q, k, v and out are read in their [B, S, H, D] layout through strides:
//     no transposed copies.

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

template <typename T, int D>
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

template <typename T, int D>
cudaError_t launch(void* q, void* k, void* v, void* o, const int* qpos,
                   const int* kvpos, int B, int S, int Tn, int Hq, int Hkv,
                   const int* st, float scale, int window,
                   cudaStream_t stream) {
  constexpr size_t smem = Smem<T, D>::bytes;
  auto kern = flash_fwd<T, D>;
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

template <typename T>
cudaError_t dispatch_d(int D, void* q, void* k, void* v, void* o,
                       const int* qpos, const int* kvpos, int B, int S,
                       int Tn, int Hq, int Hkv, const int* st, float scale,
                       int window, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, o, qpos, kvpos, B, S, Tn, Hq, Hkv, st,
                           scale, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, qpos, kvpos, B, S, Tn, Hq, Hkv, st,
                            scale, window, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, qpos, kvpos, B, S, Tn, Hq, Hkv, st,
                            scale, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace llmss

// strides: 12 element strides (batch, seq, head) for q, k, v, out in that
// order; the feature dim must be contiguous. window <= 0 means full causal.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int llmss_flash_attention(void* q, void* k, void* v, void* o,
                                     void* qpos, void* kvpos, void* strides,
                                     int B, int S, int T, int Hq, int Hkv,
                                     int D, int dtype, float scale,
                                     int window, void* stream) {
  using namespace llmss;
  if (B == 0 || S == 0) return 0;
  const int* st = static_cast<const int*>(strides);
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kvpos);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kF32:
      err = dispatch_d<float>(D, q, k, v, o, qp, kp, B, S, T, Hq, Hkv, st,
                              scale, window, s);
      break;
    case kBF16:
      err = dispatch_d<__nv_bfloat16>(D, q, k, v, o, qp, kp, B, S, T, Hq,
                                      Hkv, st, scale, window, s);
      break;
    case kF16:
      err = dispatch_d<__half>(D, q, k, v, o, qp, kp, B, S, T, Hq, Hkv, st,
                               scale, window, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
