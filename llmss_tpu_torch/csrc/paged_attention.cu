// K3 and K4: attention over the paged KV block pool.
//
// Replaces two TPU kernels:
//   * llmss_tpu/ops/pallas_paged_decode.py::paged_decode_attention (K3):
//     single-token decode over the pool;
//   * llmss_tpu/ops/pallas_ragged.py::ragged_paged_attention (K4): a
//     CB-token query chunk per row of which q_len are live (1 for decode
//     rows, up to CB for rows streaming a prompt), without int8 scales.
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
// Query rows i >= q_len[b] are chunk padding that nothing reads: a tile
// made only of them writes zeros instead of computing (the Pallas kernel
// computes them as finite garbage); padding rows that share a tile with
// live rows are computed like the reference's.
// Numerics follow the Pallas kernels: fp32 scores and running max / sum /
// accumulators, masked scores at the finite fp32 minimum, probabilities of
// masked slots exactly 0, P rounded to the value dtype before the cache's
// P.V.
//
// Two instantiations; the wrapper picks one from the dtype and CB alone and
// this file refuses any other pairing:
//
// bf16 at CB > 1 (K4 with prompt chunks) -> paged_mma, the tensor-core
// tile of attn_tile.cuh. What bounds it on the H100: bytes. Each (row, KV
// head) needs the row's live blocks once, shared by its q_len*G query
// rows; at the serve shapes that read is the whole bound, far under the
// ~295 flops per byte where the tensor cores would limit. The design: one
// block per (row, KV head, 64 flat query rows f = i*G + g), so a chunk of
// 128 queries streams its row's KV twice (once per tile) where the lane
// template's 8-row tiles streamed it 16 times; each 64-slot tile is
// gathered through block_tables by one cp.async per 16 bytes of a slot
// row, double-buffered so the next tile's copy overlaps this tile's
// products; tiles no row can see are skipped before their copy; the fresh
// keys follow as trailing tiles of <= 64 keys read from k_new / v_new on
// the same tensor-core loop. Their P is therefore rounded to bf16 like the
// cache's, where the Pallas kernel applies fresh V in fp32: one more
// rounding of P, which chip_smoke.py's 2^-7 relative tolerance already
// bounds (its derivation assumes every P is rounded).
//
// fp32 at any CB, and CB == 1 (K3, and K4 all-decode) -> paged_fwd, the
// lane template below (fp32 on the tensor cores would mean TF32). K3 is
// its CB = 1 launch: the ragged masks then reduce exactly to the decode
// masks, so an all-decode batch through K4 at CB = 1 runs the same
// instantiation, grid and instruction sequence as K3 and gives
// bit-identical outputs. Here the fresh V is applied in fp32. At decode
// each (row, KV head) reads the row's live blocks for G query heads, ~4
// flops per KV byte, so bytes bound it too. Its design:
//   * one block per (row, KV head, tile of R <= 8 of the CB*G query rows);
//     the block walks the row's table columns itself (the TPU's sequential
//     (row, column) grid becomes a loop), reading the stacked pool in place
//     at the layer offset: no per-layer slice and no gathered copy;
//   * each lane reads 16 bytes of a slot's K and V and keeps several slots
//     in flight; slots no row of the tile can see are not loaded;
//   * every lane group keeps its own running softmax per query row; the
//     partial states merge by shuffles, then through shared memory, where
//     the fresh keys are folded in, up to the last key any row of the tile
//     can see (one key for a decode row).
// Later work: a split over table columns when B*Hkv leaves SMs idle at
// small batch (flash-decoding), for the GQA decode case.

#include "attn_tile.cuh"
#include "common.cuh"

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
};

template <int D, int R>
struct Cfg {
  static constexpr int LPS = D / 8;          // lanes per slot (8 elements each)
  static constexpr int SPW = 32 / LPS;       // slots per warp per step
  static constexpr int U = R >= 4 ? 2 : 4;   // steps kept in flight
  static constexpr int SLOTS = NWARP * SPW * U;
  // s_acc [NWARP][R][D] | s_m, s_l, s_wsc [NWARP][R] | s_den [R], pad [R]
  // | s_w [R][CB] (dynamic)
  static constexpr size_t fixed =
      sizeof(float) * (size_t(NWARP) * R * D + 3 * NWARP * R + 2 * R);
};

template <typename T, int D, int R>
__global__ void __launch_bounds__(NT) paged_fwd(Args a) {
  using C = Cfg<D, R>;
  constexpr int LPS = C::LPS, SPW = C::SPW, U = C::U;
  extern __shared__ __align__(16) float smem[];
  float* s_acc = smem;                  // [NWARP][R][D]
  float* s_m = s_acc + NWARP * R * D;   // [NWARP][R]
  float* s_l = s_m + NWARP * R;         // [NWARP][R]
  float* s_wsc = s_l + NWARP * R;       // [NWARP][R] scale of each partial
  float* s_den = s_wsc + NWARP * R;     // [R]
  float* s_w = s_den + 2 * R;           // [R][CB] fresh-key weights

  const T* q = static_cast<const T*>(a.q);
  const T* kp = static_cast<const T*>(a.kp);
  const T* vp = static_cast<const T*>(a.vp);
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

  const int qp = a.qpos[b];
  const int ql = a.qlen ? a.qlen[b] : 1;
  const int sl0 = a.slot0[b];
  const int ring = a.MB * a.bs;
  const int ncols = min(max(a.nblk[b], 0), a.n_cols);
  const int t_end = ncols * a.bs;

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

  if (i_lo >= ql) {  // a tile of chunk padding only: nobody reads it
    for (int idx = threadIdx.x; idx < R * D; idx += NT) {
      const int f = f0 + idx / D;
      if (f < nrows)
        o[((long long)(b * a.CB + f / G) * a.Hq + hk * G + f % G) * D + idx % D] =
            from_f<T>(0.f);
    }
    return;
  }
  // Fresh keys past jmax are invisible to every row of the tile.
  const int jmax = min(ql, i_hi + 1);

  float qf[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (live[r]) {
      const int f = f0 + r;
      const int h = hk * G + f % G;
      Vec8<T> v;
      v.load(q + ((long long)(b * a.CB + qi[r]) * a.Hq + h) * D + e0);
      v.to_float(qf[r]);
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
  const int* kvp = a.kvpos + (long long)b * ring;
  const int* bt = a.tables + (long long)b * a.MB;
  const int last_blk = a.Np - 2;  // N - 1: block N is the write drop target

  for (int t0 = 0; t0 < t_end; t0 += C::SLOTS) {
    Vec8<T> kv[U], vv[U];
    int pp[U];
    bool any[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + (u * NWARP + warp) * SPW + sub;
      any[u] = false;
      pp[u] = -1;
      if (t < t_end) {
        const int p = kvp[t];
        int d = t - sl0;
        if (d < 0) d += ring;
        any[u] = p >= 0 && d >= ql && p <= qp + i_hi &&
                 (a.window <= 0 || p > qp + i_lo - a.window);
        pp[u] = p;
      }
      if (any[u]) {
        const int blk = min(bt[t / a.bs], last_blk);
        const long long off =
            base + (long long)blk * blk_stride + (long long)(t % a.bs) * slot_stride;
        kv[u].load(kp + off);
        vv[u].load(vp + off);
      }
    }
    float s[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8];
      if (any[u]) kv[u].to_float(kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float d = 0.f;
        if (any[u]) {
#pragma unroll
          for (int e = 0; e < 8; ++e) d = fmaf(qf[r][e], kf[e], d);
        }
#pragma unroll
        for (int off = LPS / 2; off > 0; off >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, off);
        const bool vis = any[u] && live[r] && pp[u] <= qp + qi[r] &&
                         (a.window <= 0 || pp[u] > qp + qi[r] - a.window);
        s[u][r] = vis ? d * a.scale : kNegInf;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float m_new = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) m_new = fmaxf(m_new, s[u][r]);
      if (m_new == kNegInf) continue;  // nothing visible yet in this stream
      const float alpha = expf(m[r] - m_new);
      l[r] *= alpha;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (s[u][r] == kNegInf) continue;  // masked slots contribute 0
        const float p = expf(s[u][r] - m_new);
        l[r] += p;
        const float pr = round_to<T>(p);
        float vf[8];
        vv[u].to_float(vf);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[r][e] = fmaf(pr, vf[e], acc[r][e]);
      }
      m[r] = m_new;
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

template <typename T, int D, int R>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = Cfg<D, R>::fixed + sizeof(float) * size_t(R) * a.CB;
  auto kern = paged_fwd<T, D, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (a.CB * (a.Hq / a.Hkv) + R - 1) / R;
  dim3 grid(a.B, a.Hkv * tiles);
  kern<<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_r(int R, const Args& a, cudaStream_t s) {
  switch (R) {
    case 1: return launch<T, D, 1>(a, s);
    case 2: return launch<T, D, 2>(a, s);
    case 4: return launch<T, D, 4>(a, s);
    case 8: return launch<T, D, 8>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_d(int D, int R, const Args& a, cudaStream_t s) {
  switch (D) {
    case 64: return dispatch_r<T, 64>(R, a, s);
    case 128: return dispatch_r<T, 128>(R, a, s);
    case 256: return dispatch_r<T, 256>(R, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// -- bf16 at CB > 1: the tensor-core tile ----------------------------------

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

template <int D>
__global__ void __launch_bounds__(tile::kThreads) paged_mma(Args a) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  const int b = blockIdx.x, hk = blockIdx.y;
  PagedSrc<D> s;
  s.G = a.Hq / a.Hkv;
  s.b = b;
  s.hk = hk;
  s.CB = a.CB;
  s.Hq = a.Hq;
  s.Hkv = a.Hkv;
  s.f0 = blockIdx.z * tile::kRows;
  s.nrows = a.CB * s.G;
  s.ql = a.qlen[b];
  const int i_lo = s.f0 / s.G;
  const int i_hi = (min(s.f0 + tile::kRows, s.nrows) - 1) / s.G;
  s.q = static_cast<const T*>(a.q);
  s.o = static_cast<T*>(a.o);
  if (i_lo >= s.ql) {  // a tile of chunk padding only: nobody reads it
    for (int idx = threadIdx.x; idx < tile::kRows * D; idx += tile::kThreads) {
      const int r = idx / D;
      if (s.has(r)) s.o[s.q_off(r) + idx % D] = from_f<T>(0.f);
    }
    return;
  }
  s.kp = static_cast<const T*>(a.kp);
  s.vp = static_cast<const T*>(a.vp);
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
  tile::attend<T, D, true>(s, tile_smem);
}

template <int D>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  constexpr size_t smem = tile::Smem<D>::bytes;
  auto kern = paged_mma<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = a.CB * (a.Hq / a.Hkv);
  dim3 grid(a.B, a.Hkv, (rows + tile::kRows - 1) / tile::kRows);
  kern<<<grid, tile::kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(int D, const Args& a, cudaStream_t s) {
  switch (D) {
    case 64: return launch_mma<64>(a, s);
    case 128: return launch_mma<128>(a, s);
    case 256: return launch_mma<256>(a, s);
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
// (1, 2, 4 or 8) query rows per block, for fp32 or CB == 1; 1 = paged_mma,
// for bf16 at CB > 1 (q_len required). window <= 0 means full causal.
// Returns cudaGetLastError() after the launch.
extern "C" int llmss_paged_attention(
    void* q, void* kp, void* vp, void* kn, void* vn, void* o, void* qpos,
    void* qlen, void* kvpos, void* tables, void* nblk, void* slot0, int layer,
    int B, int CB, int Np, int bs, int MB, int n_cols, int Hq, int Hkv, int D,
    int R, int dtype, int impl, float scale, int window, void* stream) {
  using namespace llmss;
  if (B == 0) return 0;
  Args a{q, kp, vp, kn, vn, o,
         static_cast<const int*>(qpos), static_cast<const int*>(qlen),
         static_cast<const int*>(kvpos), static_cast<const int*>(tables),
         static_cast<const int*>(nblk), static_cast<const int*>(slot0),
         layer, B, CB, Np, bs, MB, n_cols, Hq, Hkv, scale, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mma = dtype == kBF16 && CB > 1;
  cudaError_t err = cudaErrorInvalidValue;
  if (impl == 1 && mma && qlen != nullptr) {
    err = dispatch_mma(D, a, s);
  } else if (impl == 0 && !mma) {
    if (dtype == kF32) err = dispatch_d<float>(D, R, a, s);
    if (dtype == kBF16) err = dispatch_d<__nv_bfloat16>(D, R, a, s);
  }
  return static_cast<int>(err);
}
