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
// What bounds it on the card: serving decode (one query row against a
// cache of up to max_len keys) reads every live K/V byte once and does
// 4 * live_keys * d flops per row, far below the ~295 flops per byte
// where Hopper's tensor cores become the limit: decode is bound by K/V
// bytes. Prefill at the engine's buckets (<= 256 rows) is a small
// problem: b * h * ceil(sq / 8) blocks of short key loops.
//
// What the design does about it: one block per (b*h row, 8-query tile).
// Its four warps split the key axis: warp w walks the 32-key tiles
// t = w, w + 4, w + 8, ... (lane j owns key 32t + j), each warp with its
// own running max / sum / accumulator for the block's rows, and the four
// partial states merge in a fixed order at the end. So even a single
// decode row keeps four warps loading and computing, and a row's
// arithmetic depends only on its live tiles, never on sk or on which
// other rows share the block: decode through the paged engine
// (sk = max_len), decode through generate() (sk = prompt + new) and the
// same position inside a causal prefill give the same bits. Tiles with
// no attendable pair (past the causal frontier, outside the window band,
// or with no matching segment id, i.e. the dead tail of a decode cache)
// are skipped before their K/V are read, so decode moves only live bytes.
// Scores and probabilities stay in registers and shared memory; HBM sees
// Q, K, V once and O, lse once. Not yet used: wgmma, TMA, vector loads,
// prefetching the next tile (later work, see ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int kBQ = 8;      // query rows per block
constexpr int kBK = kTileRows;  // keys per warp tile: lane j owns key j
constexpr int kWarps = 4;   // warps split the key tiles round-robin
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
  uint32_t seed;        // dropout seed
  uint32_t threshold;   // keep iff hash < threshold
  float keep_prob;
};

// Per warp: a K tile [kBK][d + 1] (padded, so lanes reading their own
// key's column hit distinct banks) and a V tile [kBK][d]; the same space
// holds the warp's partial state for the final merge. Then the q tile
// [kBQ][d] and the q segment ids.
__host__ __device__ inline int warp_floats(int d) { return kBK * (d + 1) + kBK * d; }

size_t smem_bytes(int d) {
  return sizeof(float) * (size_t)(kWarps * warp_floats(d) + kBQ * d) +
         sizeof(int) * kBQ;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// NCH = ceil(d / 32): output columns each lane owns (lane + 32 * c).
template <typename T, int NCH>
__global__ void __launch_bounds__(kWarps * 32) flash_fwd_kernel(Params p) {
  extern __shared__ float smem[];
  const int d = p.d;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* k_s = smem + warp * warp_floats(d);
  float* v_s = k_s + kBK * (d + 1);
  float* q_s = smem + kWarps * warp_floats(d);
  int* qseg_s = reinterpret_cast<int*>(q_s + kBQ * d);

  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y;
  const int bi = bh / p.h;
  const int hi = bh % p.h;
  const int hk = hi / (p.h / p.hkv);
  const int nq = min(kBQ, p.sq - q0);
  const int q_last = q0 + nq - 1;
  const bool has_seg = p.qseg != nullptr;
  const T* __restrict__ Q = static_cast<const T*>(p.q);
  const T* __restrict__ K = static_cast<const T*>(p.k);
  const T* __restrict__ V = static_cast<const T*>(p.v);

  for (int i = tid; i < kBQ * d; i += blockDim.x) {
    const int r = i / d;
    const int c = i - r * d;
    float x = 0.f;
    if (r < nq) x = to_f32(Q[((size_t)(bi * p.sq + q0 + r) * p.h + hi) * d + c]);
    q_s[i] = x;
  }
  if (has_seg && tid < kBQ) qseg_s[tid] = tid < nq ? p.qseg[bi * p.sq + q0 + tid] : 0;
  __syncthreads();

  float m[kBQ], l[kBQ], acc[kBQ][NCH];
#pragma unroll
  for (int r = 0; r < kBQ; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[r][c] = 0.f;
  }

  const int ntiles = (p.sk + kBK - 1) / kBK;
  for (int t = warp; t < ntiles; t += kWarps) {
    const int k0 = t * kBK;
    const int kn = min(kBK, p.sk - k0);
    // Tiles wholly past the causal frontier (and every later one) and
    // tiles wholly outside the band are skipped (uniform over the warp).
    if (p.causal && k0 > q_last) break;
    if (p.has_window && !(q0 - (k0 + kn - 1) < p.window)) continue;
    const int kp = k0 + lane;
    const bool in_range = lane < kn;
    int ks = 0;
    if (has_seg) {
      ks = in_range ? p.kseg[bi * p.sk + kp] : 0;
      bool live = false;
#pragma unroll
      for (int r = 0; r < kBQ; ++r)
        live |= r < nq && ks != 0 && ks == qseg_s[r];
      // No attendable pair in this tile: skip it before its K/V leave HBM.
      if (!__any_sync(kFull, live)) continue;
    }
    __syncwarp();  // this warp's previous tile is no longer read
    stage_rows<T, NCH>(k_s, d + 1, v_s, d, K, V, bi, p.sk, p.hkv, hk, k0, d, lane);
    __syncwarp();

    // Scores: lane j holds s[r] = q_r . k_j for the block's rows.
    float s[kBQ];
#pragma unroll
    for (int r = 0; r < kBQ; ++r) s[r] = 0.f;
    const float* krow = k_s + lane * (d + 1);
    if (nq == 1) {  // decode: one row (the same chain over c as below)
#pragma unroll 8
      for (int c = 0; c < d; ++c) s[0] = fmaf(q_s[c], krow[c], s[0]);
    } else {        // rows past nq hold zero queries; their s is unused
#pragma unroll 4
      for (int c = 0; c < d; ++c) {
        const float kc = krow[c];
#pragma unroll
        for (int r = 0; r < kBQ; ++r) s[r] = fmaf(q_s[r * d + c], kc, s[r]);
      }
    }

#pragma unroll
    for (int r = 0; r < kBQ; ++r) {
      if (r >= nq) break;  // uniform over the block
      const int qp = q0 + r;
      bool live = in_range;
      if (p.causal) live = live && qp >= kp;
      if (p.has_window) live = live && (qp - kp < p.window);
      if (has_seg) live = live && ks != 0 && ks == qseg_s[r];
      const float sr = live ? s[r] * p.scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float alpha = expf(m[r] - m_new);
      const float pr = live ? expf(sr - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(pr);
#pragma unroll
      for (int c = 0; c < NCH; ++c) acc[r][c] *= alpha;
      m[r] = m_new;
      float pv = pr;
      if (p.dropout)
        pv = dropout_keep(p.seed, (uint32_t)bh, (uint32_t)qp, (uint32_t)kp, p.threshold)
                 ? pr / p.keep_prob : 0.f;
      s[r] = pv;  // s now holds this lane's (dropped) probability for row r
    }

    // acc[r][:] += sum_j p_rj * v_j, p_rj broadcast from lane j.
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vj[NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int col = lane + 32 * c;
        vj[c] = col < d ? v_s[j * d + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kBQ; ++r) {
        if (r >= nq) break;
        const float pj = __shfl_sync(kFull, s[r], j);
#pragma unroll
        for (int c = 0; c < NCH; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
  }

  // Merge the four warps' partial states, in warp order. Each warp parks
  // its state in its own tile space: [kBQ] m, [kBQ] l, [kBQ][d] acc.
  __syncwarp();
  float* part = k_s;
  if (lane < kBQ) {
#pragma unroll
    for (int r = 0; r < kBQ; ++r)
      if (r == lane) {
        part[r] = m[r];
        part[kBQ + r] = l[r];
      }
  }
#pragma unroll
  for (int r = 0; r < kBQ; ++r) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = lane + 32 * c;
      if (col < d) part[2 * kBQ + r * d + col] = acc[r][c];
    }
  }
  __syncthreads();

  T* O = static_cast<T*>(p.o);
  for (int i = tid; i < nq * d; i += blockDim.x) {
    const int r = i / d;
    const int c = i - r * d;
    float mw[kWarps];
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = smem[w * warp_floats(d) + r];
      mx = fmaxf(mx, mw[w]);
    }
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* pw = smem + w * warp_floats(d);
      const float f = expf(mw[w] - mx);
      lsum += pw[kBQ + r] * f;
      o += pw[2 * kBQ + r * d + c] * f;
    }
    const float l_safe = lsum == 0.f ? 1.f : lsum;
    const int qp = q0 + r;
    O[((size_t)(bi * p.sq + qp) * p.h + hi) * d + c] = from_f32<T>(o / l_safe);
    if (c == 0) p.lse[(size_t)bh * p.sq + qp] = mx + logf(l_safe);
  }
}

template <typename T, int NCH>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  cudaError_t err =
      raise_smem_limit(flash_fwd_kernel<T, NCH>, smem_bytes(kMaxD), configured);
  if (err != cudaSuccess) return err;
  dim3 grid((p.sq + kBQ - 1) / kBQ, p.b * p.h);
  flash_fwd_kernel<T, NCH><<<grid, kWarps * 32, smem_bytes(p.d), stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  switch ((p.d + 31) / 32) {
    case 1: return launch<T, 1>(p, stream);
    case 2: return launch<T, 2>(p, stream);
    case 3: return launch<T, 3>(p, stream);
    case 4: return launch<T, 4>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = success). Allocates nothing: O and lse come from the caller.
// dropout != 0 applies the keep mask (seed, threshold) with 1/keep_prob.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* qseg, const void* kseg, void* o, void* lse,
                         int b, int sq, int sk, int h, int hkv, int d,
                         int causal, int has_window, int window,
                         int dropout, unsigned int seed, unsigned int threshold,
                         float keep_prob, int dtype, void* stream) {
  if (d < 1 || d > kMaxD || hkv < 1 || h % hkv != 0) return (int)cudaErrorInvalidValue;
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
  p.seed = seed;
  p.threshold = threshold;
  p.keep_prob = keep_prob;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch<float>(p, st)
                  : dtype == 1 ? dispatch<__nv_bfloat16>(p, st)
                               : cudaErrorInvalidValue;
  return (int)err;
}
