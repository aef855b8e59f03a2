// Helpers shared by the flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): f32 conversion of the input types,
// the warp's staging of 32-row tiles into shared memory, the per-device
// shared-memory limit, the attention-dropout keep mask, and the device's
// own count of the kernel's launches.
//
// The keep mask is the TPU kernels' counter-based hash
// (fluxmpi_tpu/ops/flash_attention.py::_dropout_keep, _hash_mix,
// _hash_final): three murmur3 mixing rounds over (seed, b*h + head,
// q_pos, k_pos), b and head counted in the whole batch (hash_row), and the
// murmur3 finalizer, all in uint32 arithmetic, then
// keep iff the bits are below threshold = min(floor(keep_prob * 2^32),
// 2^32 - 1). The forward and both backward kernels rebuild the same bits
// for a (row, query, key) whatever their tiling, so no mask is stored.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileRows = 32;    // rows a warp stages at once: lane j owns row j
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Stage rows r0 .. r0 + 31 of two [b, S, H, d] tensors (batch bi, head hd)
// into shared tiles with row strides lda and ldb floats, through
// registers: every load is unconditional (the row and the column are
// clamped into the tensor; rows past S are zeroed afterwards), so a lane
// keeps ~32 loads in flight instead of waiting on each one. NCH =
// ceil(d / 32): the columns each lane owns (lane + 32 * c).
template <typename T, int NCH>
__device__ __forceinline__ void stage_rows(float* a_dst, int lda, float* b_dst, int ldb,
                                           const T* __restrict__ A,
                                           const T* __restrict__ B, int bi, int S,
                                           int H, int hd, int r0, int d, int lane) {
  constexpr int kStage = NCH == 1 ? 16 : NCH == 2 ? 8 : 4;
  const int n = min(kTileRows, S - r0);
  for (int j0 = 0; j0 < kTileRows; j0 += kStage) {
    float ar[kStage][NCH], br[kStage][NCH];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const int row = min(r0 + j0 + u, S - 1);
      const size_t off = ((size_t)(bi * S + row) * H + hd) * d;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int col = min(lane + 32 * c, d - 1);
        ar[u][c] = to_f32(A[off + col]);
        br[u][c] = to_f32(B[off + col]);
      }
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const bool in = j0 + u < n;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int col = lane + 32 * c;
        if (col < d) {
          a_dst[(j0 + u) * lda + col] = in ? ar[u][c] : 0.f;
          b_dst[(j0 + u) * ldb + col] = in ? br[u][c] : 0.f;
        }
      }
    }
  }
}

// The dynamic shared-memory limit is a per-device attribute of a kernel:
// raise it to `bytes` once on each device the kernel launches on.
// `configured` is the caller's per-kernel flag array.
template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, size_t bytes, bool* configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  return cudaSuccess;
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t hash_mix(uint32_t h, uint32_t k) {
  k *= 0xCC9E2D51u;
  k = rotl32(k, 15);
  k *= 0x1B873593u;
  h ^= k;
  h = rotl32(h, 13);
  return h * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t hash_final(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// Launches the device ran, CUDA-graph replays included: the first thread
// of block (0, 0, 0) of every launch adds one. Each kernel source builds
// into a library of its own, so each library holds its own counter, read
// and reset through its `device_launches` entry.
__device__ unsigned long long g_device_launches;

__device__ __forceinline__ void count_launch() {
  if ((blockIdx.x | blockIdx.y | blockIdx.z | threadIdx.x) == 0)
    atomicAdd(&g_device_launches, 1ull);
}

// The hash's row key of local batch row bi and head hi: the row of the
// whole batch's grid, (b0 + bi) * hg + h0 + hi, where b0 is the launch's
// first batch row and h0 its first head of hg in the whole batch (a
// worker's share of a data- or tensor-parallel batch). b0 = h0 = 0 and
// hg = h give the local bi * h + hi.
__device__ __forceinline__ uint32_t hash_row(int b0, int h0, int hg, int bi, int hi) {
  return (uint32_t)(b0 + bi) * (uint32_t)hg + (uint32_t)(h0 + hi);
}

__device__ __forceinline__ bool dropout_keep(uint32_t seed, uint32_t bh, uint32_t q_pos,
                                             uint32_t k_pos, uint32_t threshold) {
  const uint32_t h = hash_mix(hash_mix(hash_mix(seed, bh), q_pos), k_pos);
  return hash_final(h) < threshold;
}

}  // namespace

// Copy the current device's launch count into *out, then zero it if
// `reset`. Synchronous: call it between launches, never inside a capture.
extern "C" int device_launches(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_device_launches, sizeof(*out));
  if (err == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    err = cudaMemcpyToSymbol(g_device_launches, &zero, sizeof(zero));
  }
  return (int)err;
}
