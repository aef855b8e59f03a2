// Flash-attention backward, dQ, for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces: fluxmpi_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel (the
// Pallas TPU dQ pass, launched by _bwd_pallas through pl.pallas_call).
// Same function: for each query row, over its attendable keys,
//   p  = exp(s - lse)            (s = q.k / sqrt(d); 0 where masked)
//   dp = dO . v                  (dropout: keep ? dp / keep_prob : 0)
//   ds = p * (dp - dterm) / sqrt(d)
//   dQ = sum_k ds * k
// with dterm = rowsum(dO * O) - dlse computed by the caller, f32
// accumulation whatever the input type, dQ cast once at the end. Masking
// as in the forward: causal frontier, window band (band only when
// causal == 0), segment ids (attend iff q_seg == kv_seg and kv_seg != 0),
// grouped-query heads. Masked pairs are selected to 0 before they enter
// any product: a row with no attendable key has lse = -1e30, where
// exp(s - lse) overflows to inf and inf * 0 would be NaN.
//
// What bounds it on the card: at the training shape (b 8, s 1024, h 12,
// d 64, causal) its three products (Q K^T, dO V^T, dS K) are 19.3 GFLOP.
// In f32 that is operations: three TF32 products per f32 product at 495
// TFLOP/s, 0.117 ms, beside 0.038 ms for the 126 MB of Q, K, V, dO and
// dQ. In bf16 the two bounds meet: 63 MB at 3.35 TB/s is 0.019 ms, the
// products at 989 TFLOP/s 0.020 ms.
//
// What the design does about it: the forward's layout (flash_fwd.cu) with
// all three products on the tensor cores (flash_mma.cuh: split TF32 for
// f32, bf16 MMA for bf16 with dS split into bf16 hi + lo): four key streams,
// blocks of G row groups of 16 query rows (heaviest causal blocks first),
// one warp per (row group, stream), the G warps of a stream sharing a
// cp.async ring of its next live K/V tiles. Each warp keeps its own f32
// dQ partial for its rows in registers; the four partials are summed in
// stream order at the end: dQ is written once, with no atomics, and the
// same inputs give the same bits. Tiles with no attendable pair are
// skipped before their K/V are read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

constexpr int kStreams = 4;  // key-tile streams: tile t belongs to stream t % 4
constexpr int kMaxD = 128;

struct Params {
  const void* q;       // [b, sq, h, d]
  const void* k;       // [b, sk, h_kv, d]
  const void* v;       // [b, sk, h_kv, d]
  const int* qseg;     // [b, sq] or null
  const int* kseg;     // [b, sk] or null
  const void* dout;    // [b, sq, h, d], q's type
  const float* lse;    // [b, h, sq]
  const float* dterm;  // [b, h, sq]
  void* dq;            // [b, sq, h, d]
  int b, sq, sk, h, hkv, d;
  int causal, has_window, window;
  float scale;
  int dropout;
  const uint32_t* seed;  // dropout seed: one uint32 in device memory
  uint32_t threshold;
  float keep_prob;
  int vec;             // K/V rows are 16-byte aligned: cp.async copies
};

// As in flash_fwd.cu, with four key streams: G row groups of 16 query
// rows, G * 4 warps, warp (g, w) on row group g and key stream w, the G
// warps of a stream sharing its ring. Shared memory: per stream a ring of
// S slots, each a K and a V tile [BK][LD] (the same space holds its warps'
// dQ partials for the final sum), then the block's q and dO tiles [16
// G][LD], and its rows' lse, dterm and segment ids.
template <typename T, int DP, int G, int S>
struct Layout {
  static constexpr int kBQ = kRows * G;
  static constexpr int kThreads = 32 * kStreams * G;
  static constexpr int kBK = TileShape<T>::kBK;
  static constexpr int kLD = DP + TileShape<T>::kPad;
  static constexpr int kTile = kBK * kLD;              // elements
  static constexpr int kStreamElems = S * 2 * kTile;   // S stages x (K, V)
  static constexpr int kPartFloats = kRows * DP;
  static constexpr size_t kBytes =
      sizeof(T) * (size_t)(kStreams * kStreamElems + 2 * kBQ * kLD) +
      sizeof(float) * 3 * kBQ;
  static_assert(sizeof(T) * kStreamElems >= sizeof(float) * G * kPartFloats,
                "a stream's ring holds its warps' dQ partials");
};

template <typename T, int DP, int G, int S>
__global__ void __launch_bounds__(Layout<T, DP, G, S>::kThreads) flash_bwd_dq_kernel(Params p) {
  count_launch();
  // The dropout seed, read once per block before the key loop.
  const uint32_t seed = p.dropout ? __ldg(p.seed) : 0u;
  using L = Layout<T, DP, G, S>;
  constexpr int BK = L::kBK, LD = L::kLD, BQ = L::kBQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* q_s = ring + kStreams * L::kStreamElems;
  T* do_s = q_s + BQ * LD;
  float* lse_s = reinterpret_cast<float*>(do_s + BQ * LD);
  float* dterm_s = lse_s + BQ;
  int* qseg_s = reinterpret_cast<int*>(dterm_s + BQ);
  const int d = p.d;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = (tid >> 5) % kStreams;  // key stream
  const int rg = (tid >> 5) / kStreams;  // row group
  const int g = lane >> 2, t4 = lane & 3;
  T* my_ring = ring + w * L::kStreamElems;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest causal tiles first
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

  stage_tile<T, BQ, DP, LD>(q_s, static_cast<const T*>(p.q), bi, p.sq, p.h, hi, q0, d,
                            false, tid, L::kThreads);
  stage_tile<T, BQ, DP, LD>(do_s, static_cast<const T*>(p.dout), bi, p.sq, p.h, hi, q0, d,
                            false, tid, L::kThreads);
  for (int r = tid; r < BQ; r += L::kThreads) {
    const bool in = r < nq;
    lse_s[r] = in ? p.lse[(size_t)bh * p.sq + q0 + r] : 0.f;
    dterm_s[r] = in ? p.dterm[(size_t)bh * p.sq + q0 + r] : 0.f;
    qseg_s[r] = has_seg && in ? p.qseg[bi * p.sq + q0 + r] : 0;
  }
  __syncthreads();

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int row_g = rg * kRows + g;  // this thread's rows in the block: row_g, row_g + 8
  const int qs[2] = {qseg_s[row_g], qseg_s[row_g + 8]};
  const float lse_r[2] = {lse_s[row_g], lse_s[row_g + 8]};
  const float dterm_r[2] = {dterm_s[row_g], dterm_s[row_g + 8]};
  const T* my_q = q_s + rg * kRows * LD;
  const T* my_do = do_s + rg * kRows * LD;

  const int stream_tid = rg * 32 + lane;
  auto copy_tile = [&](int tt, int stage) {
    T* k_s = my_ring + stage * 2 * L::kTile;
    stage_tile<T, BK, DP, LD>(k_s, K, bi, p.sk, p.hkv, hk, tt * BK, d, p.vec, stream_tid,
                              32 * G);
    stage_tile<T, BK, DP, LD>(k_s + L::kTile, V, bi, p.sk, p.hkv, hk, tt * BK, d, p.vec,
                              stream_tid, 32 * G);
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
  int stage = 0;  // tq[0]'s slot
  while (tq[0] >= 0) {
    const int tt = tq[0];
    const int ks = kq[0];
#pragma unroll
    for (int i = 0; i + 1 < S - 1; ++i) {
      tq[i] = tq[i + 1];
      kq[i] = kq[i + 1];
    }
    tq[S - 2] = next_live_tile<BK, BQ>(p, stream, kStreams, bi, q0, nq, qseg_s, lane, kq[S - 2]);
    if (tq[S - 2] >= 0) copy_tile(tq[S - 2], stage == 0 ? S - 1 : stage - 1);
    cp_async_commit();
    cp_async_wait<S - 1>();
    stream_sync(w, 32 * G);  // the current tile is in shared memory

    const int k0 = tt * BK;
    const T* k_s = my_ring + stage * 2 * L::kTile;
    // A tile past this row group's causal frontier adds nothing to it.
    if (!p.causal || k0 <= r0 + kRows - 1) {
      float s[BK / 8][4], dp[BK / 8][4];
      score_product<DP, BK, LD>(s, my_q, k_s, lane);
      score_product<DP, BK, LD>(dp, my_do, k_s + L::kTile, lane);

      // ds for this thread's pairs, 0 wherever the pair is masked.
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t4 + (e & 1);
          const int key_seg = has_seg ? __shfl_sync(kFull, ks, col) : 0;
          const int qp = r0 + g + 8 * (e >> 1);
          const int kp = k0 + col;
          float ds = 0.f;
          if (qp < q0 + nq && pair_live(p, qp, kp, qs[e >> 1], key_seg)) {
            const float pr = expf(s[j][e] * p.scale - lse_r[e >> 1]);
            float gr = dp[j][e];
            if (p.dropout)
              gr = dropout_keep(seed, (uint32_t)bh, (uint32_t)qp, (uint32_t)kp, p.threshold)
                       ? gr / p.keep_prob : 0.f;
            ds = pr * (gr - dterm_r[e >> 1]) * p.scale;
          }
          s[j][e] = ds;  // s now holds ds
        }
      }
      value_product<DP, BK, LD>(acc, s, k_s, lane);
    }

    stream_sync(w, 32 * G);  // every warp is done with this stage before it refills
    stage = stage + 1 == S ? 0 : stage + 1;
  }
  cp_async_wait<0>();
  __syncthreads();  // every stream is done with its ring

  // Sum the four streams' partials in stream order; warp (g, w) parks its
  // [16][DP] partial in stream w's ring, slot g.
  float* part = reinterpret_cast<float*>(my_ring) + rg * L::kPartFloats;
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e >> 1);
      part[r * DP + 8 * n + 2 * t4 + (e & 1)] = acc[n][e];
    }
  }
  __syncthreads();

  T* DQ = static_cast<T*>(p.dq);
  for (int i = tid; i < nq * d; i += L::kThreads) {
    const int r = i / d;
    const int c = i - r * d;
    const int at = (r / kRows) * L::kPartFloats + (r % kRows) * DP + c;
    float gsum = 0.f;
#pragma unroll
    for (int sw = 0; sw < kStreams; ++sw)
      gsum += reinterpret_cast<const float*>(ring + sw * L::kStreamElems)[at];
    DQ[((size_t)(bi * p.sq + q0 + r) * p.h + hi) * d + c] = from_f32<T>(gsum);
  }
}

template <typename T, int DP, int G, int S>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using L = Layout<T, DP, G, S>;
  static bool configured[kMaxDevices] = {};
  cudaError_t err = raise_smem_limit(flash_bwd_dq_kernel<T, DP, G, S>, L::kBytes, configured);
  if (err != cudaSuccess) return err;
  dim3 grid((p.sq + L::kBQ - 1) / L::kBQ, p.b * p.h);
  flash_bwd_dq_kernel<T, DP, G, S><<<grid, L::kThreads, L::kBytes, stream>>>(p);
  return cudaGetLastError();
}

// Block shape per launch: G row groups sharing each tile copy when the
// grid still fills the card twice over, with S ring slots; else one row
// group and two slots.
template <typename T, int DP, int G, int S>
cudaError_t launch_shape(const Params& p, cudaStream_t stream) {
  const long blocks = (long)p.b * p.h * ((p.sq + kRows * G - 1) / (kRows * G));
  return blocks >= 2 * 132 ? launch<T, DP, G, S>(p, stream) : launch<T, DP, 1, 2>(p, stream);
}

// d is padded with zero columns up to the MMA depth DP.
template <typename T>
cudaError_t dispatch(Params p, cudaStream_t stream) {
  p.vec = (p.d * sizeof(T)) % 16 == 0 && (uintptr_t)p.k % 16 == 0 && (uintptr_t)p.v % 16 == 0;
  if (p.d <= 32) return launch_shape<T, 32, 4, 3>(p, stream);
  if (p.d <= 64) return launch_shape<T, 64, 4, 3>(p, stream);
  return launch_shape<T, 128, 2, 2>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and dq). lse and dterm
// are f32 [b, h, sq]. Returns cudaGetLastError() after the launch (0 =
// success). Allocates nothing: dq comes from the caller.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* qseg, const void* kseg, const void* dout,
                            const void* lse, const void* dterm, void* dq,
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
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.dterm = static_cast<const float*>(dterm);
  p.dq = dq;
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
