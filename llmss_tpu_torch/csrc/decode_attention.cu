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
// What bounds it on the H100: memory. Each (row, kv head) streams
// t_len * D keys and values once and does ~4 flops per element for each of
// its G query heads, far below the ~295 flops per byte where the tensor
// cores would become the limit. What the design does about it:
//   * the layer is addressed in place (cache + layer*B*T*Hkv*D), the GPU
//     form of the Pallas kernel's scalar-prefetched layer index: no
//     per-layer slice copy;
//   * one block per (row, kv head, group of up to 8 query heads): a KV
//     element is read once for all the query heads that share it (GQA/MQA);
//   * each lane reads 16 bytes at a time and keeps several slots' keys and
//     values in flight before it computes, so the loads of a block overlap;
//   * every half-warp (D = 128) keeps its own running max / sum / output
//     over the slots it read; the partial states are merged with shuffles
//     and then through shared memory at the end, where the fresh token is
//     folded in.
// Known limit: at small batch with few kv heads the grid has fewer blocks
// than the 132 SMs (a split over T with a merge pass is the next step).

#include "common.cuh"

namespace llmss {
namespace {

constexpr int NWARP = 8;
constexpr int NT = NWARP * 32;

template <int D, int GB>
struct Cfg {
  static constexpr int LPS = D / 8;          // lanes per slot (8 elements each)
  static constexpr int SPW = 32 / LPS;       // slots per warp per step
  static constexpr int U = GB >= 4 ? 2 : 4;  // steps kept in flight
  static constexpr int SLOTS = NWARP * SPW * U;  // slots per block iteration
  static constexpr size_t smem =
      sizeof(float) * (size_t(NWARP) * GB * D + 2 * NWARP * GB + GB);
};

template <typename T, int D, int GB>
__global__ void __launch_bounds__(NT) decode_fwd(
    const T* __restrict__ q, const T* __restrict__ kc,
    const T* __restrict__ vc, const T* __restrict__ kn,
    const T* __restrict__ vn, T* __restrict__ o,
    const int* __restrict__ qpos, const int* __restrict__ kvpos,
    const int* __restrict__ slots, int layer, int B, int Tn, int t_len,
    int Hq, int Hkv, float scale, int window) {
  using C = Cfg<D, GB>;
  constexpr int LPS = C::LPS, SPW = C::SPW, U = C::U;
  extern __shared__ __align__(16) float smem[];
  float* s_acc = smem;                       // [NWARP][GB][D]
  float* s_m = s_acc + NWARP * GB * D;       // [NWARP][GB]
  float* s_l = s_m + NWARP * GB;             // [NWARP][GB]
  float* s_new = s_l + NWARP * GB;           // [GB] fresh-token scores

  const int b = blockIdx.x;
  const int G = Hq / Hkv;
  const int hk = blockIdx.y / (G / GB);
  const int h0 = hk * G + (blockIdx.y % (G / GB)) * GB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPS, part = lane % LPS;
  const int e0 = part * 8;  // this lane's 8 features

  const int qp = qpos[b];
  const int slot = slots[b];
  const long long row_stride = (long long)Hkv * D;
  const long long base =
      ((long long)layer * B + b) * (long long)Tn * row_stride + hk * D + e0;
  const int* kvp = kvpos + (long long)b * Tn;

  float qf[GB][8];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    Vec8<T> v;
    v.load(q + ((long long)b * Hq + h0 + g) * D + e0);
    v.to_float(qf[g]);
  }

  float m[GB], l[GB], acc[GB][8];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  for (int t0 = 0; t0 < t_len; t0 += C::SLOTS) {
    Vec8<T> kv[U], vv[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + (u * NWARP + warp) * SPW + sub;
      ok[u] = false;
      if (t < t_len) {
        const int p = kvp[t];
        ok[u] = p >= 0 && p <= qp && t != slot &&
                (window <= 0 || p > qp - window);
      }
      if (ok[u]) {
        kv[u].load(kc + base + (long long)t * row_stride);
        vv[u].load(vc + base + (long long)t * row_stride);
      }
    }
    float s[U][GB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
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
        s[u][g] = ok[u] ? d * scale : kNegInf;
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) m_new = fmaxf(m_new, s[u][g]);
      if (m_new == kNegInf) continue;  // nothing visible yet in this stream
      const float alpha = expf(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
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
  }

  // Merge the SPW slot streams of this warp (lanes differing in `sub`).
#pragma unroll
  for (int off = LPS; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mm = fmaxf(m[g], m_o);
      const float a = expf(m[g] - mm), bo = expf(m_o - mm);
      l[g] = l[g] * a + l_o * bo;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float acc_o = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + acc_o * bo;
      }
      m[g] = mm;
    }
  }
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
  // Fresh-token scores: warp g computes head g's q . k_new.
  if (warp < GB) {
    float d = 0.f;
    const T* knp = kn + ((long long)b * Hkv + hk) * D;
    const T* qh = q + ((long long)b * Hq + h0 + warp) * D;
    for (int e = lane; e < D; e += 32) d = fmaf(to_f<T>(qh[e]), to_f<T>(knp[e]), d);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    if (lane == 0) s_new[warp] = d * scale;
  }
  __syncthreads();

  const T* vnp = vn + ((long long)b * Hkv + hk) * D;
  for (int i = threadIdx.x; i < GB * D; i += NT) {
    const int g = i / D, d = i % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) M = fmaxf(M, s_m[w * GB + g]);
    float L = 0.f, O = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) {
      const float a = expf(s_m[w * GB + g] - M);
      L += s_l[w * GB + g] * a;
      O += s_acc[(w * GB + g) * D + d] * a;
    }
    const float sn = s_new[g];
    const float M2 = fmaxf(M, sn);
    const float alpha = expf(M - M2);
    const float pn = expf(sn - M2);
    const float out = (O * alpha + pn * to_f<T>(vnp[d])) / (L * alpha + pn);
    o[((long long)b * Hq + h0 + g) * D + d] = from_f<T>(out);
  }
}

template <typename T, int D, int GB>
cudaError_t launch(void* q, void* kc, void* vc, void* kn, void* vn, void* o,
                   const int* qpos, const int* kvpos, const int* slots,
                   int layer, int B, int Tn, int t_len, int Hq, int Hkv,
                   float scale, int window, cudaStream_t stream) {
  constexpr size_t smem = Cfg<D, GB>::smem;
  auto kern = decode_fwd<T, D, GB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B, Hkv * ((Hq / Hkv) / GB));
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const T*>(kn),
      static_cast<const T*>(vn), static_cast<T*>(o), qpos, kvpos, slots,
      layer, B, Tn, t_len, Hq, Hkv, scale, window);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_g(int GB, void* q, void* kc, void* vc, void* kn,
                       void* vn, void* o, const int* qpos, const int* kvpos,
                       const int* slots, int layer, int B, int Tn, int t_len,
                       int Hq, int Hkv, float scale, int window,
                       cudaStream_t s) {
#define LLMSS_CASE(G)                                                       \
  case G:                                                                   \
    return launch<T, D, G>(q, kc, vc, kn, vn, o, qpos, kvpos, slots, layer, \
                           B, Tn, t_len, Hq, Hkv, scale, window, s);
  switch (GB) {
    LLMSS_CASE(1)
    LLMSS_CASE(2)
    LLMSS_CASE(4)
    LLMSS_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef LLMSS_CASE
}

template <typename T>
cudaError_t dispatch_d(int D, int GB, void* q, void* kc, void* vc, void* kn,
                       void* vn, void* o, const int* qpos, const int* kvpos,
                       const int* slots, int layer, int B, int Tn, int t_len,
                       int Hq, int Hkv, float scale, int window,
                       cudaStream_t s) {
  switch (D) {
    case 64:
      return dispatch_g<T, 64>(GB, q, kc, vc, kn, vn, o, qpos, kvpos, slots,
                               layer, B, Tn, t_len, Hq, Hkv, scale, window, s);
    case 128:
      return dispatch_g<T, 128>(GB, q, kc, vc, kn, vn, o, qpos, kvpos, slots,
                                layer, B, Tn, t_len, Hq, Hkv, scale, window,
                                s);
    case 256:
      return dispatch_g<T, 256>(GB, q, kc, vc, kn, vn, o, qpos, kvpos, slots,
                                layer, B, Tn, t_len, Hq, Hkv, scale, window,
                                s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace llmss

// q [B,1,Hq,D], cache [L,B,T,Hkv,D], k_new / v_new [B,1,Hkv,D], out
// [B,1,Hq,D], all contiguous; q_pos / slots [B] and kv_pos [B,T] int32.
// GB (1, 2, 4 or 8, dividing Hq/Hkv) query heads per block. window <= 0
// means full causal. Returns cudaGetLastError() after the launch.
extern "C" int llmss_decode_attention(void* q, void* kc, void* vc, void* kn,
                                      void* vn, void* o, void* qpos,
                                      void* kvpos, void* slots, int layer,
                                      int B, int T, int t_len, int Hq,
                                      int Hkv, int D, int GB, int dtype,
                                      float scale, int window, void* stream) {
  using namespace llmss;
  if (B == 0) return 0;
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kvpos);
  const int* sl = static_cast<const int*>(slots);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kF32:
      err = dispatch_d<float>(D, GB, q, kc, vc, kn, vn, o, qp, kp, sl, layer,
                              B, T, t_len, Hq, Hkv, scale, window, s);
      break;
    case kBF16:
      err = dispatch_d<__nv_bfloat16>(D, GB, q, kc, vc, kn, vn, o, qp, kp, sl,
                                      layer, B, T, t_len, Hq, Hkv, scale,
                                      window, s);
      break;
    case kF16:
      err = dispatch_d<__half>(D, GB, q, kc, vc, kn, vn, o, qp, kp, sl, layer,
                               B, T, t_len, Hq, Hkv, scale, window, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
