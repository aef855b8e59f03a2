// Flash-attention backward, dK and dV, for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces: fluxmpi_tpu/ops/flash_attention.py::_flash_bwd_dkv_kernel (the
// Pallas TPU dK/dV pass, launched by _bwd_pallas through pl.pallas_call).
// Same function: for each key row of a kv head, over the attendable
// queries of every query head of its group,
//   p      = exp(s - lse)               (s = q.k / sqrt(d); 0 where masked)
//   p_drop = keep ? p / keep_prob : p   (dropout; keep = 1 without it)
//   dp     = dO . v, dropped the same way
//   dV    += p_drop * dO
//   dK    += p * (dp - dterm) / sqrt(d) * q
// with dterm = rowsum(dO * O) - dlse computed by the caller, f32
// accumulation, dK and dV cast once at the end. The dropout hash is keyed
// by the QUERY row b*h + head (of the whole batch: hash_row), rebuilt here
// for each query head of the group (as the TPU kernel does), and by the
// absolute positions, so the bits equal the forward's whatever the tiling.
// Masking as in the forward: causal frontier, window band (band only when
// causal == 0), segment ids, grouped-query heads. Masked pairs are
// selected to 0 before they enter any product (a row with no attendable
// key has lse = -1e30, where exp overflows).
//
// What bounds it on the card: at the training shape (b 8, s 1024, h 12,
// d 64, causal) its four products (K Q^T, V dO^T, P^T dO, dS^T Q) are 25.8
// GFLOP. In f32 that is operations: three TF32 products per f32 product at
// 495 TFLOP/s, 0.156 ms, beside 0.045 ms for the Q, K, V, dO, dK and dV
// bytes. In bf16, operations too: 0.026 ms at 989 TFLOP/s beside 0.023 ms
// of bytes. In practice a tile step is bound by latency: too few warps
// per SM to hide the MMA, shared-memory and copy latencies of each step.
//
// What the design does about it: the dQ kernel's layout (flash_bwd_dq.cu)
// transposed, all four products on the tensor cores (flash_mma.cuh: split
// TF32 for f32, bf16 MMA for bf16 with P_drop^T and dS^T split into bf16
// hi + lo).
// A block owns G row groups of 16 key rows of one b*h_kv row (the MMA
// rows); the lowest key blocks, which see the most causal queries, launch
// first. Its K and V rows stay resident in shared memory for the whole
// sweep, split to TF32 hi/lo once per block in f32 (their loads overlap
// the first tiles' copies). The streamed tiles are (query head of the
// group, query tile) pairs, group-major as the TPU kernel orders them,
// walked from each head's causal frontier to its window edge and cut into
// NS fixed streams: iteration i belongs to stream i % NS. One warp per
// (row group, stream); the G warps of a stream share a cp.async ring of S
// slots holding the stream's next live Q and dO tiles of BQ queries with
// their lse, dterm and segment id columns. Tiles whose query segment ids
// meet no key of the block are skipped before their Q/dO are read. A warp
// computes a tile in chunks of CHUNK queries (scores, elementwise pass,
// dV/dK products), so it holds few score registers; chunks whose pairs are
// all live (most causal chunks) skip the mask tests. The shapes (Shape,
// above) give G * NS = 12 warps of at most 168 registers and no spill at
// d <= 64. Each warp keeps f32 dK and dV partials for its 16 key rows in
// registers; the NS stream partials are summed in stream order at the
// end: each dK/dV row has one writer, no atomics, and the same inputs give
// the same bits (the TPU kernel's single-writer design). Not yet used:
// wgmma with a TMA producer warp (ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

constexpr int kMaxD = 128;

// f32 K/V rows are split to TF32 once per block; bf16 rows are read as
// they are (scripts/dkv_variants.py times f32 split on every tile too).
template <typename T>
constexpr bool kSplitOnce = sizeof(T) == 4;

// The block shape at d <= 64 per input type: queries per streamed tile
// (kBQ), row groups (kG), query streams (kNS) and ring slots (kS); and at
// every d the queries a warp computes at once (kChunk: a multiple of the
// MMA k step, 16 for bf16). Both give 12 warps of at most 168 registers
// and no spill; scripts/dkv_variants.py builds and times other choices.
template <typename T>
struct Shape;
template <>
struct Shape<float> {
  static constexpr int kBQ = 32, kG = 6, kNS = 2, kS = 2, kChunk = 8;
};
template <>
struct Shape<__nv_bfloat16> {
  static constexpr int kBQ = 64, kG = 6, kNS = 2, kS = 2, kChunk = 16;
};

struct Params {
  const void* q;       // [b, sq, h, d]
  const void* k;       // [b, sk, h_kv, d]
  const void* v;       // [b, sk, h_kv, d]
  const int* qseg;     // [b, sq] or null
  const int* kseg;     // [b, sk] or null
  const void* dout;    // [b, sq, h, d], q's type
  const float* lse;    // [b, h, sq]
  const float* dterm;  // [b, h, sq]
  void* dk;            // [b, sk, h_kv, d]
  void* dv;            // [b, sk, h_kv, d]
  int b, sq, sk, h, hkv, d;
  int causal, has_window, window;
  float scale;
  int dropout;
  const uint32_t* seed;  // dropout seed: one uint32 in device memory
  uint32_t threshold;
  float keep_prob;
  int b0, h0, hg;        // the dropout hash's rows: (b0 + b) * hg + h0 + head
  int vec;             // Q, K, V and dO rows are 16-byte aligned: cp.async copies
};

// G row groups of 16 key rows, NS query streams, G * NS warps: warp (g,
// w) on row group g and stream w; BQ queries per streamed tile. Shared
// memory: per stream a ring of S slots, each a Q and a dO tile [BQ][LD]
// and the tile's lse, dterm and query segment id columns; then the
// resident K and V rows (f32: per row group, the TF32 hi and lo A
// fragments of K and of V; bf16: K and V rows [16 G][LD]); then the
// block's key segment ids. After the sweep the same space holds the
// warps' dK, then dV, partials [NS][16 G][DP] for the final sum.
template <typename T, int DP, int BQ, int G, int NS, int S>
struct Layout {
  static constexpr int kBKey = kRows * G;
  static constexpr int kThreads = 32 * NS * G;
  static constexpr int kBQ = BQ;
  static constexpr int kLD = DP + TileShape<T>::kPad;
  static constexpr int kTile = kBQ * kLD;        // elements of a Q or dO tile
  static constexpr int kFrags = (DP / 8) * 32;   // uint4 A fragments per split operand
  static constexpr size_t kSlotBytes = sizeof(T) * 2 * kTile + sizeof(float) * 3 * kBQ;
  static constexpr size_t kStreamBytes = S * kSlotBytes;
  static constexpr size_t kResidentBytes =
      kSplitOnce<T> ? sizeof(uint4) * (size_t)G * 4 * kFrags : sizeof(T) * 2 * kBKey * kLD;
  static constexpr size_t kSweepBytes = NS * kStreamBytes + kResidentBytes + sizeof(int) * kBKey;
  static constexpr size_t kPartBytes = sizeof(float) * NS * kBKey * DP;
  static constexpr size_t kBytes = kSweepBytes > kPartBytes ? kSweepBytes : kPartBytes;
  static_assert(kSlotBytes % 16 == 0 && (kLD * sizeof(T)) % 16 == 0, "16-byte slots and rows");
  static_assert(BQ % Shape<T>::kChunk == 0, "whole chunks of queries per tile");
};

// The block's sweep: for each query head of the group, the query tiles
// t_lo .. t_lo + per_head - 1 hold every pair the block's keys can attend
// (from the causal frontier to the window edge). Iteration i is head i /
// per_head, tile t_lo + i % per_head: group-major.
struct Sweep {
  int t_lo, per_head, total;
};

// A stream's walk over its iterations cand, cand + step, ...: qs[i][u]
// is the segment id of query lane + 32 u (< BQ) of iteration cand + i *
// step, loaded W iterations ahead.
template <int W, int BQ>
struct QueryWalk {
  static constexpr int kPerLane = (BQ + 31) / 32;
  int cand;
  int qs[W][kPerLane];
};

template <int BQ, int N>
__device__ __forceinline__ void load_query_segs(int (&qs)[N], const Params& p, const Sweep& sw,
                                                int it, int bi, int lane) {
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int col = lane + 32 * u;
    const int q = it < sw.total ? (sw.t_lo + it % sw.per_head) * BQ + col : p.sq;
    qs[u] = p.qseg != nullptr && col < BQ && q < p.sq ? p.qseg[bi * p.sq + q] : 0;
  }
}

// The walk's next live iteration, or -1. An iteration is live unless
// segment ids are given and none of its queries shares one with a key of
// the block (kseg_s[0 .. nk - 1]). Uniform over the warp; reads no Q/dO.
template <int BQ, int W>
__device__ __forceinline__ int next_live_iter(const Params& p, const Sweep& sw,
                                              QueryWalk<W, BQ>& walk, int step, int bi,
                                              const int* kseg_s, int nk, int lane) {
  constexpr int N = QueryWalk<W, BQ>::kPerLane;
  for (;;) {
    const int it = walk.cand;
    if (it >= sw.total) return -1;
    int qs[N];
#pragma unroll
    for (int u = 0; u < N; ++u) qs[u] = walk.qs[0][u];
    walk.cand = it + step;
#pragma unroll
    for (int i = 0; i + 1 < W; ++i)
#pragma unroll
      for (int u = 0; u < N; ++u) walk.qs[i][u] = walk.qs[i + 1][u];
    load_query_segs<BQ>(walk.qs[W - 1], p, sw, it + W * step, bi, lane);
    if (p.qseg == nullptr) return it;
    bool live = false;
#pragma unroll
    for (int u = 0; u < N; ++u)
      if (qs[u] != 0)
        for (int r = 0; r < nk; ++r) live |= kseg_s[r] == qs[u];
    if (__any_sync(kFull, live)) return it;
  }
}

template <typename T, int DP, int BQ, int G, int NS, int S>
__global__ void __launch_bounds__(Layout<T, DP, BQ, G, NS, S>::kThreads, 1)
    flash_bwd_dkv_kernel(Params p) {
  count_launch();
  // The dropout seed, read once per block before the key loop.
  const uint32_t seed = p.dropout ? __ldg(p.seed) : 0u;
  using L = Layout<T, DP, BQ, G, NS, S>;
  constexpr int LD = L::kLD, BKey = L::kBKey, kChunk = Shape<T>::kChunk;
  constexpr int W = S - 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* resident = smem_raw + NS * L::kStreamBytes;
  int* kseg_s = reinterpret_cast<int*>(resident + L::kResidentBytes);
  const int d = p.d;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = (tid >> 5) % NS;   // query stream
  const int rg = (tid >> 5) / NS;  // row group
  const int g = lane >> 2, t4 = lane & 3;
  unsigned char* my_ring = smem_raw + w * L::kStreamBytes;

  const int bk = blockIdx.x;  // b * h_kv + kv head
  const int bi = bk / p.hkv;
  const int hk = bk % p.hkv;
  const int group = p.h / p.hkv;
  const int k0 = blockIdx.y * BKey;  // lowest (heaviest causal) key blocks first
  const int nk = min(BKey, p.sk - k0);
  const int r0 = k0 + rg * kRows;  // this warp's first key row
  const bool has_seg = p.qseg != nullptr;
  const T* __restrict__ Q = static_cast<const T*>(p.q);
  const T* __restrict__ DO = static_cast<const T*>(p.dout);

  Sweep sw;
  {
    const int ntiles = (p.sq + BQ - 1) / BQ;
    sw.t_lo = p.causal ? min(k0 / BQ, ntiles) : 0;
    int t_hi = ntiles;
    if (p.has_window) {
      // Tile t holds a live pair iff t * BQ - (k0 + nk - 1) < window.
      const long long lim = (long long)k0 + nk - 1 + p.window;
      t_hi = lim <= 0 ? 0 : (int)min((long long)ntiles, (lim + BQ - 1) / BQ);
    }
    sw.per_head = max(0, t_hi - sw.t_lo);
    sw.total = group * sw.per_head;
  }
  for (int r = tid; r < BKey; r += L::kThreads)
    kseg_s[r] = has_seg && r < nk ? p.kseg[bi * p.sk + k0 + r] : 0;
  QueryWalk<W, BQ> walk;
  walk.cand = w;
#pragma unroll
  for (int i = 0; i < W; ++i) load_query_segs<BQ>(walk.qs[i], p, sw, w + i * NS, bi, lane);
  __syncthreads();  // the walk reads kseg_s

  const int stream_tid = rg * 32 + lane;
  auto slot_at = [&](int stage) { return my_ring + stage * L::kSlotBytes; };
  auto copy_tile = [&](int it, int stage) {
    const int hq = hk * group + it / sw.per_head;
    const int q0 = (sw.t_lo + it % sw.per_head) * BQ;
    T* q_s = reinterpret_cast<T*>(slot_at(stage));
    stage_tile<T, BQ, DP, LD>(q_s, Q, bi, p.sq, p.h, hq, q0, d, p.vec, stream_tid, 32 * G);
    stage_tile<T, BQ, DP, LD>(q_s + L::kTile, DO, bi, p.sq, p.h, hq, q0, d, p.vec, stream_tid,
                              32 * G);
    // lse, dterm and segment id of the tile's queries; 0 past sq.
    float* cols = reinterpret_cast<float*>(q_s + 2 * L::kTile);
    const size_t row = (size_t)(bi * p.h + hq) * p.sq;
    for (int i = stream_tid; i < (has_seg ? 3 : 2) * BQ; i += 32 * G) {
      const int q = q0 + i % BQ;
      const void* src = i < BQ       ? (const void*)(p.lse + row + q)
                        : i < 2 * BQ ? (const void*)(p.dterm + row + q)
                                     : (const void*)(p.qseg + (size_t)bi * p.sq + q);
      cp_async4(cols + i, q < p.sq ? src : p.lse, q < p.sq ? 4 : 0);
    }
  };

  // bf16 K/V rows join the first tile's copy group.
  if constexpr (!kSplitOnce<T>) {
    T* kv = reinterpret_cast<T*>(resident);
    stage_tile<T, BKey, DP, LD>(kv, static_cast<const T*>(p.k), bi, p.sk, p.hkv, hk, k0, d,
                                p.vec, tid, L::kThreads);
    stage_tile<T, BKey, DP, LD>(kv + BKey * LD, static_cast<const T*>(p.v), bi, p.sk, p.hkv,
                                hk, k0, d, p.vec, tid, L::kThreads);
  }
  // The stream's next S - 1 live iterations (-1: none), each copied into
  // its ring slot as soon as it is known.
  int tq[W];
#pragma unroll
  for (int i = 0; i < W; ++i) {
    tq[i] = next_live_iter<BQ>(p, sw, walk, NS, bi, kseg_s, nk, lane);
    if (tq[i] >= 0) copy_tile(tq[i], i);
    cp_async_commit();
  }
  if constexpr (kSplitOnce<T>) {
    // f32 K and V rows, split to TF32 once while the first tiles load:
    // fragment i = (operand, row group, k step, lane), operand 0 = K, 1 =
    // V, stored as [operand * G + row group][hi, lo][k step][lane]. The
    // loads of kBatch fragments are issued before their splits.
    constexpr int kPer = 2 * G * L::kFrags / L::kThreads;
    constexpr int kBatch = kPer < 4 ? kPer : 4;
    static_assert(kPer * L::kThreads == 2 * G * L::kFrags && kPer % kBatch == 0,
                  "whole fragments per thread");
    uint4* frag = reinterpret_cast<uint4*>(resident);
#pragma unroll
    for (int u0 = 0; u0 < kPer; u0 += kBatch) {
      float x[kBatch][4];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = tid + (u0 + u) * L::kThreads;
        const int og = i / L::kFrags;  // operand * G + row group
        const float* src = static_cast<const float*>(og < G ? p.k : p.v);
        const int row0 = k0 + (og % G) * kRows;
        int r[4], c[4];
        a_fragment_at((i / 32) % (DP / 8), i % 32, r, c);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[u][e] = row0 + r[e] < p.sk && c[e] < d
                        ? src[((size_t)(bi * p.sk + row0 + r[e]) * p.hkv + hk) * d + c[e]]
                        : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = tid + (u0 + u) * L::kThreads;
        const int og = i / L::kFrags;
        uint4 hi, lo;
        split_a_fragment(hi, lo, x[u]);
        frag[(2 * og) * L::kFrags + i % L::kFrags] = hi;
        frag[(2 * og + 1) * L::kFrags + i % L::kFrags] = lo;
      }
    }
  }
  cp_async_wait<W - 1>();  // the first copy group: with it, bf16 K/V
  __syncthreads();         // K/V are resident for every warp

  float acc_k[DP / 8][4], acc_v[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  int stage = 0;  // tq[0]'s slot
  while (tq[0] >= 0) {
    const int it = tq[0];
#pragma unroll
    for (int i = 0; i + 1 < W; ++i) tq[i] = tq[i + 1];
    tq[W - 1] = next_live_iter<BQ>(p, sw, walk, NS, bi, kseg_s, nk, lane);
    if (tq[W - 1] >= 0) copy_tile(tq[W - 1], stage == 0 ? S - 1 : stage - 1);
    cp_async_commit();
    cp_async_wait<S - 1>();
    stream_sync(w, 32 * G);  // the current tile is in shared memory

    // The query head's row keys the dropout hash.
    const uint32_t hrow = hash_row(p.b0, p.h0, p.hg, bi, hk * group + it / sw.per_head);
    const int q0 = (sw.t_lo + it % sw.per_head) * BQ;
    const T* q_s = reinterpret_cast<const T*>(slot_at(stage));
    const T* do_s = q_s + L::kTile;
    const float* lse_s = reinterpret_cast<const float*>(q_s + 2 * L::kTile);
    const float* dterm_s = lse_s + BQ;
    const int* qseg_s = reinterpret_cast<const int*>(dterm_s + BQ);  // read if has_seg
    // The tile in chunks of kChunk queries: the scores, the elementwise
    // pass and the dV/dK products of one chunk at a time, so a warp holds
    // kChunk columns of S^T and dP^T. A chunk before this row group's
    // causal frontier or past its window edge adds nothing to it.
#pragma unroll 1
    for (int c0 = 0; c0 < BQ; c0 += kChunk) {
      const int qc = q0 + c0;  // the chunk's first query
      if ((p.causal && qc + kChunk - 1 < r0) ||
          (p.has_window && qc - (r0 + kRows - 1) >= p.window))
        continue;
      const T* q_c = q_s + c0 * LD;
      const T* do_c = do_s + c0 * LD;
      float s[kChunk / 8][4], dp[kChunk / 8][4];
      if constexpr (kSplitOnce<T>) {
        const uint4* frag = reinterpret_cast<const uint4*>(resident);
        const uint4* kf = frag + 2 * rg * L::kFrags;
        const uint4* vf = frag + 2 * (G + rg) * L::kFrags;
        score_product_split_a<DP, kChunk, LD>(s, kf, kf + L::kFrags, q_c, lane);
        score_product_split_a<DP, kChunk, LD>(dp, vf, vf + L::kFrags, do_c, lane);
      } else {
        const T* k_rows = reinterpret_cast<const T*>(resident) + rg * kRows * LD;
        score_product<DP, kChunk, LD>(s, k_rows, q_c, lane);
        score_product<DP, kChunk, LD>(dp, k_rows + BKey * LD, do_c, lane);
      }

      // p_drop^T into s, dS^T into dp, for this thread's (key, query)
      // pairs; both 0 wherever the pair is masked. A chunk whose pairs with
      // this row group are all live (most causal chunks) skips the tests.
      const bool full = !has_seg && qc + kChunk <= p.sq && r0 + kRows <= p.sk &&
                        (!p.causal || qc >= r0 + kRows - 1) &&
                        (!p.has_window || qc + kChunk - 1 - r0 < p.window);
      auto elementwise = [&](auto masked) {
#pragma unroll
        for (int j = 0; j < kChunk / 8; ++j) {
          const int c = c0 + 8 * j + 2 * t4;  // this thread's columns c, c + 1
          const float2 lse2 = *reinterpret_cast<const float2*>(lse_s + c);
          const float2 dterm2 = *reinterpret_cast<const float2*>(dterm_s + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c + (e & 1);
            const int qp = q0 + col;
            const int kp = r0 + g + 8 * (e >> 1);
            float pd = 0.f, ds = 0.f;
            if (!decltype(masked)::value ||
                (qp < p.sq &&
                 pair_live(p, qp, kp, has_seg ? qseg_s[col] : 0,
                           has_seg ? kseg_s[rg * kRows + g + 8 * (e >> 1)] : 0))) {
              const float pr = __expf(s[j][e] * p.scale - ((e & 1) ? lse2.y : lse2.x));
              float gr = dp[j][e];
              pd = pr;
              if (p.dropout) {
                const bool keep = dropout_keep(seed, hrow, (uint32_t)qp, (uint32_t)kp,
                                               p.threshold);
                pd = keep ? pr / p.keep_prob : 0.f;
                gr = keep ? gr / p.keep_prob : 0.f;
              }
              ds = pr * (gr - ((e & 1) ? dterm2.y : dterm2.x)) * p.scale;
            }
            s[j][e] = pd;
            dp[j][e] = ds;
          }
        }
      };
      if (full)
        elementwise(std::false_type{});
      else
        elementwise(std::true_type{});
      value_product<DP, kChunk, LD>(acc_v, s, do_c, lane);
      value_product<DP, kChunk, LD>(acc_k, dp, q_c, lane);
    }

    stream_sync(w, 32 * G);  // every warp is done with this stage before it refills
    stage = stage + 1 == S ? 0 : stage + 1;
  }
  cp_async_wait<0>();
  __syncthreads();  // every stream is done with its ring

  // dK, then dV: warp (g, w) parks its [16][DP] partial at [w][16 g ..];
  // the NS partials of a row are summed in stream order and written once.
  float* part = reinterpret_cast<float*>(smem_raw) + (w * BKey + rg * kRows) * DP;
  auto finish = [&](const float (&acc)[DP / 8][4], void* out) {
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(g + 8 * (e >> 1)) * DP + 8 * n + 2 * t4 + (e & 1)] = acc[n][e];
    }
    __syncthreads();
    T* dst = static_cast<T*>(out);
    for (int i = tid; i < nk * d; i += L::kThreads) {
      const int r = i / d;
      const int c = i - r * d;
      float sum = 0.f;
#pragma unroll
      for (int sw_ = 0; sw_ < NS; ++sw_)
        sum += reinterpret_cast<const float*>(smem_raw)[(sw_ * BKey + r) * DP + c];
      dst[((size_t)(bi * p.sk + k0 + r) * p.hkv + hk) * d + c] = from_f32<T>(sum);
    }
    __syncthreads();
  };
  finish(acc_k, p.dk);
  finish(acc_v, p.dv);
}

template <typename T, int DP, int BQ, int G, int NS, int S>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using L = Layout<T, DP, BQ, G, NS, S>;
  static bool configured[kMaxDevices] = {};
  const auto kernel = flash_bwd_dkv_kernel<T, DP, BQ, G, NS, S>;
  cudaError_t err = raise_smem_limit(kernel, L::kBytes, configured);
  if (err != cudaSuccess) return err;
  dim3 grid(p.b * p.hkv, (p.sk + L::kBKey - 1) / L::kBKey);
  kernel<<<grid, L::kThreads, L::kBytes, stream>>>(p);
  return cudaGetLastError();
}

// Block shape per launch: G row groups sharing each Q/dO tile copy when
// the grid still fills the card twice over; else one row group.
template <typename T, int DP, int BQ, int G, int NS, int S>
cudaError_t launch_shape(const Params& p, cudaStream_t stream) {
  const long blocks = (long)p.b * p.hkv * ((p.sk + kRows * G - 1) / (kRows * G));
  return blocks >= 2 * 132 ? launch<T, DP, BQ, G, NS, S>(p, stream)
                           : launch<T, DP, BQ, 1, NS, S>(p, stream);
}

// d is padded with zero columns up to the MMA depth DP.
template <typename T>
cudaError_t dispatch(Params p, cudaStream_t stream) {
  p.vec = (p.d * sizeof(T)) % 16 == 0 && (uintptr_t)p.q % 16 == 0 &&
          (uintptr_t)p.k % 16 == 0 && (uintptr_t)p.v % 16 == 0 && (uintptr_t)p.dout % 16 == 0;
  using Sh = Shape<T>;
  if (p.d <= 32) return launch_shape<T, 32, Sh::kBQ, Sh::kG, Sh::kNS, Sh::kS>(p, stream);
  if (p.d <= 64) return launch_shape<T, 64, Sh::kBQ, Sh::kG, Sh::kNS, Sh::kS>(p, stream);
  return launch_shape<T, 128, TileShape<T>::kBK, 2, 4, 2>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dk and dv). lse and
// dterm are f32 [b, h, sq]. Returns cudaGetLastError() after the launch
// (0 = success). Allocates nothing: dk and dv come from the caller.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* qseg, const void* kseg, const void* dout,
                             const void* lse, const void* dterm, void* dk, void* dv,
                             int b, int sq, int sk, int h, int hkv, int d,
                             int causal, int has_window, int window,
                             int dropout, const void* seed, unsigned int threshold,
                             float keep_prob, int b0, int h0, int hg, int dtype,
                             void* stream) {
  if (d < 1 || d > kMaxD || hkv < 1 || h % hkv != 0 || (dropout && !seed) || b0 < 0 ||
      h0 < 0 || h0 + h > hg)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || sk == 0 || hkv == 0) return (int)cudaSuccess;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.qseg = static_cast<const int*>(qseg);
  p.kseg = static_cast<const int*>(kseg);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.dterm = static_cast<const float*>(dterm);
  p.dk = dk;
  p.dv = dv;
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
  p.b0 = b0;
  p.h0 = h0;
  p.hg = hg;
  p.vec = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch<float>(p, st)
                  : dtype == 1 ? dispatch<__nv_bfloat16>(p, st)
                               : cudaErrorInvalidValue;
  return (int)err;
}
