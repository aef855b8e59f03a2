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
// by the QUERY row b*h + head, rebuilt here for each query head of the
// group (as the TPU kernel does), and by the absolute positions, so the
// bits equal the forward's whatever the tiling. Masked pairs are selected
// to 0 before they enter any product (a row with no attendable key has
// lse = -1e30, where exp overflows).
//
// What bounds it on the card: 4 products of live_pairs * d flops in f32 at
// the training shapes: bound by operations. What the design does about
// it, simply: the forward's layout transposed. One block per (b*h_kv row,
// 8-key tile); its four warps split the (query head of the group, 32-query
// tile) iterations round-robin from the causal frontier on (lane j owns
// query 32t + j), each warp keeps f32 dK and dV partials for the block's
// keys in registers, and the partials are summed in warp order at the
// end: each dK/dV row has one writer, no atomics, and the same inputs give
// the same bits (the TPU kernel's single-writer design). Not yet used:
// tensor cores (wgmma), TMA, register tiling (later work, see ROADMAP.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int kBKey = 8;    // key rows per block
constexpr int kBQ = kTileRows;  // queries per warp tile: lane j owns query j
constexpr int kWarps = 4;   // warps split the query tiles round-robin
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
  void* dk;            // [b, sk, h_kv, d]
  void* dv;            // [b, sk, h_kv, d]
  int b, sq, sk, h, hkv, d;
  int causal, has_window, window;
  float scale;
  int dropout;
  uint32_t seed, threshold;
  float keep_prob;
};

// Per warp: a Q tile and a dO tile, [kBQ][d + 1] each (padded: lanes read
// their own query's row, and both are also read by column); the same space
// holds the warp's dK and dV partials for the final merge. Then the
// block's k and v rows [kBKey][d] each and its keys' segment ids.
__host__ __device__ inline int warp_floats(int d) { return 2 * kBQ * (d + 1); }

size_t smem_bytes(int d) {
  return sizeof(float) * (size_t)(kWarps * warp_floats(d) + 2 * kBKey * d) +
         sizeof(int) * kBKey;
}

template <typename T, int NCH>
__global__ void __launch_bounds__(kWarps * 32) flash_bwd_dkv_kernel(Params p) {
  extern __shared__ float smem[];
  const int d = p.d;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  float* q_t = smem + warp * warp_floats(d);
  float* do_t = q_t + kBQ * (d + 1);
  float* k_s = smem + kWarps * warp_floats(d);
  float* v_s = k_s + kBKey * d;
  int* kseg_s = reinterpret_cast<int*>(v_s + kBKey * d);

  const int k0 = blockIdx.x * kBKey;
  const int bk = blockIdx.y;  // b * h_kv + kv head
  const int bi = bk / p.hkv;
  const int hk = bk % p.hkv;
  const int group = p.h / p.hkv;
  const int nk = min(kBKey, p.sk - k0);
  const int k_last = k0 + nk - 1;
  const bool has_seg = p.qseg != nullptr;
  const T* __restrict__ Q = static_cast<const T*>(p.q);
  const T* __restrict__ K = static_cast<const T*>(p.k);
  const T* __restrict__ V = static_cast<const T*>(p.v);
  const T* __restrict__ DO = static_cast<const T*>(p.dout);

  for (int i = tid; i < kBKey * d; i += blockDim.x) {
    const int r = i / d;
    const int c = i - r * d;
    float x = 0.f, y = 0.f;
    if (r < nk) {
      const size_t off = ((size_t)(bi * p.sk + k0 + r) * p.hkv + hk) * d + c;
      x = to_f32(K[off]);
      y = to_f32(V[off]);
    }
    k_s[i] = x;
    v_s[i] = y;
  }
  if (has_seg && tid < kBKey) kseg_s[tid] = tid < nk ? p.kseg[bi * p.sk + k0 + tid] : 0;
  __syncthreads();

  float acc_k[kBKey][NCH], acc_v[kBKey][NCH];
#pragma unroll
  for (int r = 0; r < kBKey; ++r)
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;

  // Query tiles before the causal frontier hold no live pair: start there.
  const int ntiles = (p.sq + kBQ - 1) / kBQ;
  const int t0 = p.causal ? min(k0 / kBQ, ntiles) : 0;
  const int per_head = ntiles - t0;
  const int iters = group * per_head;
  for (int it = warp; it < iters; it += kWarps) {
    const int g = it / per_head;
    const int t = t0 + it % per_head;
    const int hi = hk * group + g;
    const int bh = bi * p.h + hi;  // the folded query row: keys the hash
    const int q0 = t * kBQ;
    const int qn = min(kBQ, p.sq - q0);
    // The forward's tile predicates, transposed (uniform over the warp).
    if (p.causal && q0 + qn - 1 < k0) continue;
    if (p.has_window && !(q0 - k_last < p.window)) continue;
    const int qp = q0 + lane;
    const bool in_range = lane < qn;
    int qs = 0;
    if (has_seg) {
      qs = in_range ? p.qseg[bi * p.sq + qp] : 0;
      bool live = false;
#pragma unroll
      for (int r = 0; r < kBKey; ++r)
        live |= r < nk && kseg_s[r] != 0 && kseg_s[r] == qs;
      if (!__any_sync(kFull, live)) continue;
    }
    const float lse = in_range ? p.lse[(size_t)bh * p.sq + qp] : 0.f;
    const float dterm = in_range ? p.dterm[(size_t)bh * p.sq + qp] : 0.f;
    __syncwarp();  // this warp's previous tile is no longer read
    stage_rows<T, NCH>(q_t, d + 1, do_t, d + 1, Q, DO, bi, p.sq, p.h, hi, q0, d,
                       lane);
    __syncwarp();

    // Lane j: s[r] = k_r . q_j and dp[r] = v_r . dO_j for the block's keys.
    float s[kBKey], dp[kBKey];
#pragma unroll
    for (int r = 0; r < kBKey; ++r) s[r] = dp[r] = 0.f;
    const float* qrow = q_t + lane * (d + 1);
    const float* grow = do_t + lane * (d + 1);
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      const float qc = qrow[c];
      const float gc = grow[c];
#pragma unroll
      for (int r = 0; r < kBKey; ++r) {
        s[r] = fmaf(k_s[r * d + c], qc, s[r]);
        dp[r] = fmaf(v_s[r * d + c], gc, dp[r]);
      }
    }

    // Per key r and this lane's query: p_drop into s[r], ds into dp[r];
    // both 0 wherever the pair is masked.
#pragma unroll
    for (int r = 0; r < kBKey; ++r) {
      const int kp = k0 + r;
      bool live = in_range && r < nk;
      if (p.causal) live = live && qp >= kp;
      if (p.has_window) live = live && (qp - kp < p.window);
      if (has_seg) live = live && kseg_s[r] != 0 && kseg_s[r] == qs;
      float pd = 0.f, ds = 0.f;
      if (live) {
        const float pr = expf(s[r] * p.scale - lse);
        float dpr = dp[r];
        pd = pr;
        if (p.dropout) {
          const bool keep =
              dropout_keep(p.seed, (uint32_t)bh, (uint32_t)qp, (uint32_t)kp, p.threshold);
          pd = keep ? pr / p.keep_prob : 0.f;
          dpr = keep ? dpr / p.keep_prob : 0.f;
        }
        ds = pr * (dpr - dterm) * p.scale;
      }
      s[r] = pd;
      dp[r] = ds;
    }

    // acc_v[r][:] += sum_j p_drop_rj * dO_j, acc_k[r][:] += sum_j ds_rj * q_j,
    // the lane-j values broadcast by shuffle.
#pragma unroll 4
    for (int j = 0; j < kBQ; ++j) {
      float qj[NCH], gj[NCH];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int col = lane + 32 * c;
        qj[c] = col < d ? q_t[j * (d + 1) + col] : 0.f;
        gj[c] = col < d ? do_t[j * (d + 1) + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kBKey; ++r) {
        if (r >= nk) break;  // uniform over the block
        const float pj = __shfl_sync(kFull, s[r], j);
        const float dj = __shfl_sync(kFull, dp[r], j);
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          acc_v[r][c] = fmaf(pj, gj[c], acc_v[r][c]);
          acc_k[r][c] = fmaf(dj, qj[c], acc_k[r][c]);
        }
      }
    }
  }

  // Sum the four warps' partials in warp order; each warp parks its
  // [kBKey][d] dK and dV partials in its own tile space.
  __syncwarp();
  float* part = q_t;
#pragma unroll
  for (int r = 0; r < kBKey; ++r) {
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int col = lane + 32 * c;
      if (col < d) {
        part[r * d + col] = acc_k[r][c];
        part[kBKey * d + r * d + col] = acc_v[r][c];
      }
    }
  }
  __syncthreads();

  T* DK = static_cast<T*>(p.dk);
  T* DV = static_cast<T*>(p.dv);
  for (int i = tid; i < nk * d; i += blockDim.x) {
    const int r = i / d;
    const int c = i - r * d;
    float gk = 0.f, gv = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* pw = smem + w * warp_floats(d);
      gk += pw[r * d + c];
      gv += pw[kBKey * d + r * d + c];
    }
    const size_t off = ((size_t)(bi * p.sk + k0 + r) * p.hkv + hk) * d + c;
    DK[off] = from_f32<T>(gk);
    DV[off] = from_f32<T>(gv);
  }
}

template <typename T, int NCH>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  cudaError_t err =
      raise_smem_limit(flash_bwd_dkv_kernel<T, NCH>, smem_bytes(kMaxD), configured);
  if (err != cudaSuccess) return err;
  dim3 grid((p.sk + kBKey - 1) / kBKey, p.b * p.hkv);
  flash_bwd_dkv_kernel<T, NCH><<<grid, kWarps * 32, smem_bytes(p.d), stream>>>(p);
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

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dk and dv). lse and
// dterm are f32 [b, h, sq]. Returns cudaGetLastError() after the launch
// (0 = success). Allocates nothing: dk and dv come from the caller.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* qseg, const void* kseg, const void* dout,
                             const void* lse, const void* dterm, void* dk, void* dv,
                             int b, int sq, int sk, int h, int hkv, int d,
                             int causal, int has_window, int window,
                             int dropout, unsigned int seed, unsigned int threshold,
                             float keep_prob, int dtype, void* stream) {
  if (d < 1 || d > kMaxD || hkv < 1 || h % hkv != 0) return (int)cudaErrorInvalidValue;
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
  p.seed = seed;
  p.threshold = threshold;
  p.keep_prob = keep_prob;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 0 ? dispatch<float>(p, st)
                  : dtype == 1 ? dispatch<__nv_bfloat16>(p, st)
                               : cudaErrorInvalidValue;
  return (int)err;
}
