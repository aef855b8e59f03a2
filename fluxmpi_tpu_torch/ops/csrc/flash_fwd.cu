// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: fluxmpi_tpu/ops/flash_attention.py::_flash_kernel (the Pallas
// TPU forward, launched by _fwd_pallas through pl.pallas_call). Same
// function: O = softmax(Q K^T / sqrt(d) + mask) V and lse = m + log(l) per
// query row, f32 running max / sum / accumulator whatever the input type,
// causal frontier, window band (band only when causal == 0), segment ids
// (attend iff q_seg == kv_seg and kv_seg != 0), grouped-query heads. A row
// with no attendable key writes O = 0 and lse = -1e30. Attention dropout
// (dropout != 0): the value accumulation sees keep ? p / keep_prob : 0,
// while l sums the undropped p (dropout after normalization, as flax and
// the TPU kernel do); the keep mask is the counter-based murmur3 hash of
// flash_common.cuh, keyed by (seed, b*h + head, q_pos, k_pos).
//
// What bounds it on the card: at the training shape (b 8, s 1024, h 12,
// d 64, causal) the two products are 12.9 GFLOP. In f32 that is
// operations: three TF32 products per f32 product (the split below) at
// 495 TFLOP/s, 0.078 ms, beside 0.030 ms for the 101 MB of Q, K, V and O.
// In bf16, bytes: 50 MB at 3.35 TB/s, 0.015 ms, beside 0.013 ms of
// tensor-core time. Serving decode (one query row against up to max_len
// cached keys) reads every live K/V byte once for 4 * live_keys * d
// flops: bound by K/V bytes.
//
// What the design does about it: both products run on the tensor cores
// (mma.sync; flash_mma.cuh): bf16 MMA for bf16 (P split into bf16 hi + lo
// for P . V), split TF32 for f32, f32 accumulation. The key axis is cut into NS fixed streams (8, or 4 at d >
// 64): stream w takes the key tiles t = w, w + NS, w + 2 NS, ... (BK keys
// each: 16 in f32, 32 in bf16), with its own running max / sum /
// accumulator per query row, and the partial states merge in stream order
// at the end. A block holds G row groups of 16 query rows (heaviest causal
// blocks first) and runs one warp per (row group, stream); the G warps of
// a stream share a ring of S shared-memory slots that cp.async fills with
// the stream's next live tiles while they compute on the current one.
// Large grids take G = 2, so one K/V copy serves 32 rows; a decode row
// takes G = 1, and its warps take the next tile's scores while they finish
// the current one. So a single decode row keeps NS warps loading and
// computing, and a row's bits depend only on its live keys, never on sq,
// sk, G, S, the dead cache tail or which rows share its tile: an MMA row
// sees only its own A row; a tile with no attendable pair for a row is an
// exact no-op for it (p = 0, and the running max does not move, so the
// rescale is exp(0) = 1); the tile width, stream and merge order depend on
// the type and d only. Decode through the paged engine (sk = max_len),
// decode through generate() (sk = prompt + new) and the same position
// inside a causal prefill of any length give the same bits. Tiles with no
// attendable pair (past the causal frontier, outside the window band, or
// with no matching segment id, i.e. the dead tail of a decode cache) are
// skipped before their K/V are read, so decode moves only live bytes. Not
// yet used: wgmma with a TMA producer warp (ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;     // [b, sq, h, d]
  const void* k;     // [b, sk, h_kv, d]
  const void* v;     // [b, sk, h_kv, d]
  const int* qseg;   // [b, sq] or null
  const int* kseg;   // [b, sk] or null
  void* o;           // [b, sq, h, d]
  float* lse;        // [b, h, sq]
  int b, sq, sk, h, hkv, d;
  int causal, has_window, window;
  float scale;
  int dropout;          // nonzero: apply the keep mask to the value path
  const uint32_t* seed;  // dropout seed: one uint32 in device memory
  uint32_t threshold;   // keep iff hash < threshold
  float keep_prob;
  int vec;              // K/V rows are 16-byte aligned: cp.async copies
};

// A block holds G row groups of 16 query rows and runs G * kStreams
// warps: warp (g, w) computes row group g against key stream w, and the G
// warps of a stream share its ring, so one copy of a K/V tile serves 16 G
// rows.
// Shared memory: per stream a ring of S slots, each a K and a V tile
// [BK][LD] (the same space holds its warps' partial states for the final
// merge), then the block's q tile [16 G][LD] and q segment ids.
template <typename T, int DP, int G, int S>
struct Layout {
  // Key-tile streams: tile t belongs to stream t % kStreams. A function of
  // d only, so every launch of one head width splits a row's keys alike.
  static constexpr int kStreams = DP <= 64 ? 8 : 4;
  static constexpr int kBQ = kRows * G;
  static constexpr int kThreads = 32 * kStreams * G;
  static constexpr int kBK = TileShape<T>::kBK;
  static constexpr int kLD = DP + TileShape<T>::kPad;
  static constexpr int kTile = kBK * kLD;              // elements
  static constexpr int kStreamElems = S * 2 * kTile;   // S stages x (K, V)
  static constexpr int kPartFloats = 2 * kRows + kRows * DP;  // m, l, acc
  static constexpr size_t kBytes =
      sizeof(T) * (size_t)(kStreams * kStreamElems + kBQ * kLD) + sizeof(int) * kBQ;
  static_assert(sizeof(T) * kStreamElems >= sizeof(float) * G * kPartFloats,
                "a stream's ring holds its warps' partial states");
};

template <typename T, int DP, int G, int S>
__global__ void __launch_bounds__(Layout<T, DP, G, S>::kThreads) flash_fwd_kernel(Params p) {
  count_launch();
  // The dropout seed, read once per block before the key loop.
  const uint32_t seed = p.dropout ? __ldg(p.seed) : 0u;
  using L = Layout<T, DP, G, S>;
  constexpr int BK = L::kBK, LD = L::kLD, BQ = L::kBQ, kStreams = L::kStreams;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* q_s = ring + kStreams * L::kStreamElems;
  int* qseg_s = reinterpret_cast<int*>(q_s + BQ * LD);
  const int d = p.d;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = (tid >> 5) % kStreams;  // key stream
  const int rg = (tid >> 5) / kStreams;  // row group
  const int g = lane >> 2, t4 = lane & 3;
  T* my_ring = ring + w * L::kStreamElems;
  const T* my_q = q_s + rg * kRows * LD;

  // Causal blocks near the end of the sequence have the most key tiles:
  // start them first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int hk = hi / (p.h / p.hkv);
  const int nq = min(BQ, p.sq - q0);
  const int r0 = q0 + rg * kRows;  // this warp's first query row
  const bool has_seg = p.qseg != nullptr;
  const T* __restrict__ K = static_cast<const T*>(p.k);
  const T* __restrict__ V = static_cast<const T*>(p.v);
  // The first key segment ids are on their way while q is staged.
  KeyStream<S - 1> stream = key_stream<BK, S - 1>(p, w, kStreams, bi, lane);

  // Rows past nq hold zero queries: their results are never written.
  stage_tile<T, BQ, DP, LD>(q_s, static_cast<const T*>(p.q), bi, p.sq, p.h, hi, q0, d,
                            false, tid, L::kThreads);
  for (int r = tid; r < BQ; r += L::kThreads)
    qseg_s[r] = has_seg && r < nq ? p.qseg[bi * p.sq + q0 + r] : 0;
  __syncthreads();

  // This thread's rows g and g + 8 of its row group: running max, sum and
  // output columns 8n + 2t4, 8n + 2t4 + 1.
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int qs[2] = {qseg_s[rg * kRows + g], qseg_s[rg * kRows + g + 8]};

  const int stream_tid = rg * 32 + lane;
  auto copy_tile = [&](int tt, int stage) {
    T* k_s = my_ring + stage * 2 * L::kTile;
    stage_tile<T, BK, DP, LD>(k_s, K, bi, p.sk, p.hkv, hk, tt * BK, d, p.vec, stream_tid,
                              32 * G);
    stage_tile<T, BK, DP, LD>(k_s + L::kTile, V, bi, p.sk, p.hkv, hk, tt * BK, d, p.vec,
                              stream_tid, 32 * G);
  };

  // One online-softmax step over tile tt's scores s (this warp's rows g
  // and g + 8), then acc += P V with the tile's V in v_s. Masked pairs are
  // selected out before anything else sees their scores.
  auto softmax_pv = [&](int tt, int ks, const T* v_s, float (&s)[BK / 8][4]) {
    const int k0 = tt * BK;
    unsigned live_bits = 0;
    float rmax[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t4 + (e & 1);
        const int key_seg = has_seg ? __shfl_sync(kFull, ks, col) : 0;
        const bool live = pair_live(p, r0 + g + 8 * (e >> 1), k0 + col, qs[e >> 1], key_seg);
        live_bits |= (unsigned)live << (4 * j + e);
        s[j][e] = live ? s[j][e] * p.scale : kNegInf;
        rmax[e >> 1] = fmaxf(rmax[e >> 1], s[j][e]);
      }
    }
    float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(kFull, rmax[i], 1));
      rmax[i] = fmaxf(rmax[i], __shfl_xor_sync(kFull, rmax[i], 2));
      const float m_new = fmaxf(m[i], rmax[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = (live_bits >> (4 * j + e)) & 1u;
        s[j][e] = live ? expf(s[j][e] - m[e >> 1]) : 0.f;
        rsum[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rsum[i] += __shfl_xor_sync(kFull, rsum[i], 1);
      rsum[i] += __shfl_xor_sync(kFull, rsum[i], 2);
      l[i] = l[i] * alpha[i] + rsum[i];
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    if (p.dropout) {  // the value path sees the dropped probabilities
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = r0 + g + 8 * (e >> 1);
          const int kp = k0 + 8 * j + 2 * t4 + (e & 1);
          s[j][e] = dropout_keep(seed, (uint32_t)bh, (uint32_t)qp, (uint32_t)kp, p.threshold)
                        ? s[j][e] / p.keep_prob : 0.f;
        }
      }
    }
    value_product<DP, BK, LD>(acc, s, v_s, lane);
  };

  // The stream's next S - 1 live tiles (-1: none), each copied into its
  // ring slot as soon as it is known, and this lane's key segment ids in
  // them.
  int tq[S - 1], kq[S - 1];
#pragma unroll
  for (int i = 0; i < S - 1; ++i) {
    tq[i] = next_live_tile<BK, BQ>(p, stream, kStreams, bi, q0, nq, qseg_s, lane, kq[i]);
    if (tq[i] >= 0) copy_tile(tq[i], i);
    cp_async_commit();
  }
  // Before tile tq[0] is consumed, its slot's neighbour (stage - 1) is
  // refilled with the stream's next live tile.
  auto advance = [&](int stage) {
#pragma unroll
    for (int i = 0; i + 1 < S - 1; ++i) {
      tq[i] = tq[i + 1];
      kq[i] = kq[i + 1];
    }
    tq[S - 2] = next_live_tile<BK, BQ>(p, stream, kStreams, bi, q0, nq, qseg_s, lane, kq[S - 2]);
    if (tq[S - 2] >= 0) copy_tile(tq[S - 2], stage == 0 ? S - 1 : stage - 1);
    cp_async_commit();
  };
  auto slot = [&](int stage) { return my_ring + stage * 2 * L::kTile; };
  int stage = 0;  // tq[0]'s slot
  if constexpr (G == 1 && S >= 3) {
    // One row group (decode): every live tile is computed (the block's
    // causal frontier is the group's), and the next tile's scores are
    // taken while this tile's softmax step and P V run, so one warp keeps
    // two independent chains in flight. The same arithmetic in the same
    // order as below.
    float s_cur[BK / 8][4];
    cp_async_wait<S - 2>();
    stream_sync(w, 32 * G);  // tq[0] is in shared memory
    score_product<DP, BK, LD>(s_cur, my_q, slot(0), lane);
    while (tq[0] >= 0) {
      const int tt = tq[0];
      const int ks = kq[0];
      advance(stage);
      cp_async_wait<S - 2>();
      stream_sync(w, 32 * G);  // the next tile is in shared memory
      const int next = stage + 1 == S ? 0 : stage + 1;
      float s_next[BK / 8][4];  // unused past the last tile
      score_product<DP, BK, LD>(s_next, my_q, slot(next), lane);
      softmax_pv(tt, ks, slot(stage) + L::kTile, s_cur);
      stream_sync(w, 32 * G);  // every warp is done with this stage before it refills
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s_cur[j][e] = s_next[j][e];
      stage = next;
    }
  } else {
    while (tq[0] >= 0) {
      const int tt = tq[0];
      const int ks = kq[0];
      advance(stage);
      cp_async_wait<S - 1>();
      stream_sync(w, 32 * G);  // the current tile is in shared memory
      // A tile past this row group's causal frontier is a no-op for it.
      if (!p.causal || tt * BK <= r0 + kRows - 1) {
        float s[BK / 8][4];
        score_product<DP, BK, LD>(s, my_q, slot(stage), lane);
        softmax_pv(tt, ks, slot(stage) + L::kTile, s);
      }
      stream_sync(w, 32 * G);  // every warp is done with this stage before it refills
      stage = stage + 1 == S ? 0 : stage + 1;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every stream is done with its ring

  // Merge the streams' partial states, in stream order. Warp (g, w)
  // parks its state in stream w's ring, slot g: [16] m, [16] l, [16][DP]
  // acc.
  float* part = reinterpret_cast<float*>(my_ring) + rg * L::kPartFloats;
  if (t4 == 0) {
    part[g] = m[0];
    part[g + 8] = m[1];
    part[kRows + g] = l[0];
    part[kRows + g + 8] = l[1];
  }
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e >> 1);
      part[2 * kRows + r * DP + 8 * n + 2 * t4 + (e & 1)] = acc[n][e];
    }
  }
  __syncthreads();

  T* O = static_cast<T*>(p.o);
  for (int i = tid; i < nq * d; i += L::kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    const int slot = (r / kRows) * L::kPartFloats;
    const int rr = r % kRows;
    float mw[kStreams];
    float mx = kNegInf;
#pragma unroll
    for (int sw = 0; sw < kStreams; ++sw) {
      mw[sw] = reinterpret_cast<const float*>(ring + sw * L::kStreamElems)[slot + rr];
      mx = fmaxf(mx, mw[sw]);
    }
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int sw = 0; sw < kStreams; ++sw) {
      const float* pw = reinterpret_cast<const float*>(ring + sw * L::kStreamElems) + slot;
      const float f = expf(mw[sw] - mx);
      lsum += pw[kRows + rr] * f;
      o += pw[2 * kRows + rr * DP + c] * f;
    }
    const float l_safe = lsum == 0.f ? 1.f : lsum;
    const int qp = q0 + r;
    O[((size_t)(bi * p.sq + qp) * p.h + hi) * d + c] = from_f32<T>(o / l_safe);
    if (c == 0) p.lse[(size_t)bh * p.sq + qp] = mx + logf(l_safe);
  }
}

template <typename T, int DP, int G, int S>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using L = Layout<T, DP, G, S>;
  static bool configured[kMaxDevices] = {};
  cudaError_t err = raise_smem_limit(flash_fwd_kernel<T, DP, G, S>, L::kBytes, configured);
  if (err != cudaSuccess) return err;
  dim3 grid((p.sq + L::kBQ - 1) / L::kBQ, p.b * p.h);
  flash_fwd_kernel<T, DP, G, S><<<grid, L::kThreads, L::kBytes, stream>>>(p);
  return cudaGetLastError();
}

// Block shape per launch; a row's arithmetic is the same in every one.
// Large grids (training, long prefills): G row groups share each tile
// copy, S = 3 ring slots. A single row block (decode): one row group and
// S = 3 slots, the ring that lets one warp take the next tile's scores
// while it finishes the current one. Else (short prefills): one row
// group, S = 2.
template <typename T, int DP, int G, int SDecode>
cudaError_t launch_shape(const Params& p, cudaStream_t stream) {
  const long blocks = (long)p.b * p.h * ((p.sq + kRows * G - 1) / (kRows * G));
  if (blocks >= 2 * 132) return launch<T, DP, G, 3>(p, stream);
  if (p.sq <= kRows) return launch<T, DP, 1, SDecode>(p, stream);
  return launch<T, DP, 1, 2>(p, stream);
}

// d is padded with zero columns up to the MMA depth DP.
template <typename T>
cudaError_t dispatch(Params p, cudaStream_t stream) {
  p.vec = (p.d * sizeof(T)) % 16 == 0 && (uintptr_t)p.k % 16 == 0 && (uintptr_t)p.v % 16 == 0;
  if (p.d <= 32) return launch_shape<T, 32, 2, 3>(p, stream);
  if (p.d <= 64) return launch_shape<T, 64, 2, 3>(p, stream);
  return launch_shape<T, 128, 2, 3>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = success). Allocates nothing: O and lse come from the caller.
// dropout != 0 applies the keep mask (the uint32 seed that `seed` points to
// in device memory, threshold) with 1/keep_prob.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* qseg, const void* kseg, void* o, void* lse,
                         int b, int sq, int sk, int h, int hkv, int d,
                         int causal, int has_window, int window,
                         int dropout, const void* seed, unsigned int threshold,
                         float keep_prob, int dtype, void* stream) {
  if (d < 1 || d > kMaxD || hkv < 1 || h % hkv != 0 || (dropout && !seed))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || sq == 0 || h == 0) return (int)cudaSuccess;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.b = b;
  p.sq = sq;
  p.sk = sk;
  p.h = h;
  p.hkv = hkv;
  p.d = d;
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.scale = 1.0f / sqrtf((float)d);
  p.dropout = dropout;
  p.seed = static_cast<const uint32_t*>(seed);
  p.threshold = threshold;
  p.keep_prob = keep_prob;
  p.vec = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch<float>(p, st)
                  : dtype == 1 ? dispatch<__nv_bfloat16>(p, st)
                               : cudaErrorInvalidValue;
  return (int)err;
}
