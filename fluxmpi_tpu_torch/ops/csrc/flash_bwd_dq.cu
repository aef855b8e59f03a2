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
// What bounds it on the card: at the training shapes (sq = sk = 1024,
// d = 64) it does 3 products of live_pairs * d flops in f32, far above
// the bytes it moves (Q, K, V, dO once): bound by operations. What the
// design does about it, simply: the forward's layout. One block per
// (b*h row, 8-query tile); its four warps split the key axis (warp w
// walks the 32-key tiles w, w + 4, ..., lane j owns key 32t + j), each
// warp keeps its own f32 dQ partial for the block's rows in registers,
// and the four partials are summed in warp order at the end: dQ is
// written once, with no atomics, and the same inputs give the same bits.
// Tiles with no attendable pair are skipped before their K/V are read.
// Not yet used: tensor cores (wgmma), TMA, register tiling of the score
// products (later work, see ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int kBQ = 8;      // query rows per block
constexpr int kBK = kTileRows;  // keys per warp tile: lane j owns key j
constexpr int kWarps = 4;   // warps split the key tiles round-robin
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
  uint32_t seed, threshold;
  float keep_prob;
};

// Per warp: a K tile and a V tile, [kBK][d + 1] each (padded: lanes read
// their own key's row, and K is also read by column); the same space
// holds the warp's dQ partial for the final merge. Then the block's q and
// dO rows [kBQ][d] each, and its rows' lse, dterm and segment ids.
__host__ __device__ inline int warp_floats(int d) { return 2 * kBK * (d + 1); }

size_t smem_bytes(int d) {
  return sizeof(float) * (size_t)(kWarps * warp_floats(d) + 2 * kBQ * d + 2 * kBQ) +
         sizeof(int) * kBQ;
}

template <typename T, int NCH>
__global__ void __launch_bounds__(kWarps * 32) flash_bwd_dq_kernel(Params p) {
  extern __shared__ float smem[];
  const int d = p.d;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* k_s = smem + warp * warp_floats(d);
  float* v_s = k_s + kBK * (d + 1);
  float* q_s = smem + kWarps * warp_floats(d);
  float* do_s = q_s + kBQ * d;
  float* lse_s = do_s + kBQ * d;
  float* dterm_s = lse_s + kBQ;
  int* qseg_s = reinterpret_cast<int*>(dterm_s + kBQ);

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
  const T* __restrict__ DO = static_cast<const T*>(p.dout);

  for (int i = tid; i < kBQ * d; i += blockDim.x) {
    const int r = i / d;
    const int c = i - r * d;
    float x = 0.f, g = 0.f;
    if (r < nq) {
      const size_t off = ((size_t)(bi * p.sq + q0 + r) * p.h + hi) * d + c;
      x = to_f32(Q[off]);
      g = to_f32(DO[off]);
    }
    q_s[i] = x;
    do_s[i] = g;
  }
  if (tid < kBQ) {
    const bool in = tid < nq;
    lse_s[tid] = in ? p.lse[(size_t)bh * p.sq + q0 + tid] : 0.f;
    dterm_s[tid] = in ? p.dterm[(size_t)bh * p.sq + q0 + tid] : 0.f;
    if (has_seg) qseg_s[tid] = in ? p.qseg[bi * p.sq + q0 + tid] : 0;
  }
  __syncthreads();

  float acc[kBQ][NCH];
#pragma unroll
  for (int r = 0; r < kBQ; ++r)
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[r][c] = 0.f;

  const int ntiles = (p.sk + kBK - 1) / kBK;
  for (int t = warp; t < ntiles; t += kWarps) {
    const int k0 = t * kBK;
    const int kn = min(kBK, p.sk - k0);
    // The forward's tile predicates (uniform over the warp).
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
      if (!__any_sync(kFull, live)) continue;
    }
    __syncwarp();  // this warp's previous tile is no longer read
    stage_rows<T, NCH>(k_s, d + 1, v_s, d + 1, K, V, bi, p.sk, p.hkv, hk, k0, d,
                       lane);
    __syncwarp();

    // Lane j: s[r] = q_r . k_j and dp[r] = dO_r . v_j for the block's rows.
    float s[kBQ], dp[kBQ];
#pragma unroll
    for (int r = 0; r < kBQ; ++r) s[r] = dp[r] = 0.f;
    const float* krow = k_s + lane * (d + 1);
    const float* vrow = v_s + lane * (d + 1);
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      const float kc = krow[c];
      const float vc = vrow[c];
#pragma unroll
      for (int r = 0; r < kBQ; ++r) {
        s[r] = fmaf(q_s[r * d + c], kc, s[r]);
        dp[r] = fmaf(do_s[r * d + c], vc, dp[r]);
      }
    }

    // ds[r] for this lane's key, 0 wherever the pair is masked.
#pragma unroll
    for (int r = 0; r < kBQ; ++r) {
      const int qp = q0 + r;
      bool live = in_range && r < nq;
      if (p.causal) live = live && qp >= kp;
      if (p.has_window) live = live && (qp - kp < p.window);
      if (has_seg) live = live && ks != 0 && ks == qseg_s[r];
      float ds = 0.f;
      if (live) {
        const float pr = expf(s[r] * p.scale - lse_s[r]);
        float g = dp[r];
        if (p.dropout)
          g = dropout_keep(p.seed, (uint32_t)bh, (uint32_t)qp, (uint32_t)kp, p.threshold)
                  ? g / p.keep_prob : 0.f;
        ds = pr * (g - dterm_s[r]) * p.scale;
      }
      s[r] = ds;  // s now holds this lane's ds for row r
    }

    // acc[r][:] += sum_j ds_rj * k_j, ds_rj broadcast from lane j.
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float kj[NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int col = lane + 32 * c;
        kj[c] = col < d ? k_s[j * (d + 1) + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kBQ; ++r) {
        if (r >= nq) break;  // uniform over the block
        const float g = __shfl_sync(kFull, s[r], j);
#pragma unroll
        for (int c = 0; c < NCH; ++c) acc[r][c] = fmaf(g, kj[c], acc[r][c]);
      }
    }
  }

  // Sum the four warps' partials in warp order; each warp parks its
  // [kBQ][d] partial in its own tile space.
  __syncwarp();
  float* part = k_s;
#pragma unroll
  for (int r = 0; r < kBQ; ++r) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = lane + 32 * c;
      if (col < d) part[r * d + col] = acc[r][c];
    }
  }
  __syncthreads();

  T* DQ = static_cast<T*>(p.dq);
  for (int i = tid; i < nq * d; i += blockDim.x) {
    const int r = i / d;
    const int c = i - r * d;
    float g = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) g += smem[w * warp_floats(d) + r * d + c];
    DQ[((size_t)(bi * p.sq + q0 + r) * p.h + hi) * d + c] = from_f32<T>(g);
  }
}

template <typename T, int NCH>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  cudaError_t err =
      raise_smem_limit(flash_bwd_dq_kernel<T, NCH>, smem_bytes(kMaxD), configured);
  if (err != cudaSuccess) return err;
  dim3 grid((p.sq + kBQ - 1) / kBQ, p.b * p.h);
  flash_bwd_dq_kernel<T, NCH><<<grid, kWarps * 32, smem_bytes(p.d), stream>>>(p);
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

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and dq). lse and dterm
// are f32 [b, h, sq]. Returns cudaGetLastError() after the launch (0 =
// success). Allocates nothing: dq comes from the caller.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* qseg, const void* kseg, const void* dout,
                            const void* lse, const void* dterm, void* dq,
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
  p.seed = seed;
  p.threshold = threshold;
  p.keep_prob = keep_prob;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch<float>(p, st)
                  : dtype == 1 ? dispatch<__nv_bfloat16>(p, st)
                               : cudaErrorInvalidValue;
  return (int)err;
}
