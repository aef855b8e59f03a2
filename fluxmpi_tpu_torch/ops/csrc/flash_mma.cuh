// Tensor-core building blocks of flash_fwd.cu, flash_bwd_dq.cu and
// flash_bwd_dkv.cu: the tile shape per input type, asynchronous staging of
// tiles into shared memory (cp.async), the walk over a key stream's live
// tiles, the split-TF32 product for f32 inputs, bf16 MMA, and the two
// warp-level products the kernels run on a 16-row tile:
//   score_product: S[16][BK] = A[16][DP] . B[BK][DP]^T   (Q K^T, dO V^T;
//                  dK/dV pass: K Q^T, V dO^T)
//   value_product: O[16][DP] += P[16][BK] . B[BK][DP]     (P V, dS K;
//                  dK/dV pass: P^T dO, dS^T Q)
// score_product_split_a is score_product with an A operand that stays
// resident for a whole sweep, split to TF32 once (split_a_fragment).
//
// Register layouts are those of mma.sync m16n8k8 (tf32) and m16n8k16
// (bf16): with g = lane / 4 and t = lane % 4, an accumulator tile [16][8]
// holds (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1) in its four registers.
//
// f32 inputs: every product a * b runs as three TF32 products,
//   a * b ~ hi_a * hi_b + hi_a * lo_b + lo_a * hi_b,
// hi = tf32(x), lo = tf32(x - hi), both rounded to nearest in registers
// (cvt.rna.tf32.f32): about 21 mantissa bits per operand, so the result
// stays within the f32 kernels' tolerances, where one TF32 product misses
// them (tests/test_torch_tf32_split.py emulates both on the CPU).
//
// value_product for f32 takes its A operand straight from score_product's
// accumulator layout: the m16n8k8 A fragment wants columns t and t + 4,
// the accumulator holds 2t and 2t + 1, so the k index of both operands is
// permuted (A column t <-> key 2t, column t + 4 <-> key 2t + 1) and the B
// rows are read in that order. bf16: two n8 accumulator tiles form one k16
// A fragment, and B comes in by ldmatrix.trans. The A operand (P or dS, f32
// in the accumulator) is split like the f32 path's: hi = bf16(x), lo =
// bf16(x - hi), two bf16 MMAs into the same f32 accumulator, small term
// first. P . B then carries about 16 of P's bits, where one bf16 product
// keeps 8 (tests/test_torch_bf16_split.py emulates both on the CPU); the
// B operand (V, K, dO or Q) is bf16 input and exact.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

constexpr int kRows = 16;   // query rows of a warp's MMA tile (m16)

// Keys per warp tile (BK) and the row padding of shared tiles (in
// elements): a row of DP + kPad elements puts the eight rows a fragment
// load touches on distinct banks. BK depends on the type only, so a
// query row's arithmetic is a fixed function of (type, DP) and its live
// keys.
template <typename T>
struct TileShape;
template <>
struct TileShape<float> {
  static constexpr int kBK = 16;
  static constexpr int kPad = 4;
};
template <>
struct TileShape<__nv_bfloat16> {
  static constexpr int kBK = 32;
  static constexpr int kPad = 8;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One 4-byte element (an f32 or an int); src_bytes 0 zero-fills.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows r0 .. r0 + R - 1 of a [b, S, H, d] tensor (batch bi, head hd) into
// a shared tile [R][LD]; columns d .. DP - 1 and rows past S are zero.
// vec: 16-byte cp.async copies (the caller commits and waits; needs
// d * sizeof(T) and the base pointer 16-byte aligned, and zero-fills by a
// source size of 0); otherwise plain loads and stores. Threads tid, tid +
// nthreads, ... share the work.
template <typename T, int R, int DP, int LD>
__device__ __forceinline__ void stage_tile(T* dst, const T* __restrict__ src, int bi, int S,
                                           int H, int hd, int r0, int d, bool vec, int tid,
                                           int nthreads) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    constexpr int kChunks = DP / kPer;
    for (int i = tid; i < R * kChunks; i += nthreads) {
      const int row = i / kChunks;
      const int col = (i - row * kChunks) * kPer;
      const bool in = r0 + row < S && col < d;
      const T* from = in ? src + ((size_t)(bi * S + r0 + row) * H + hd) * d + col : src;
      cp_async16(dst + row * LD + col, from, in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < R * DP; i += nthreads) {
      const int row = i / DP;
      const int col = i - row * DP;
      T x = from_f32<T>(0.f);
      if (r0 + row < S && col < d) x = src[((size_t)(bi * S + r0 + row) * H + hd) * d + col];
      dst[row * LD + col] = x;
    }
  }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The three TF32 products of one f32 product, small terms first.
__device__ __forceinline__ void mma_3xtf32(float* c, const uint32_t* ah, const uint32_t* al,
                                           const uint32_t* bh, const uint32_t* bl) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bf16 hi and lo parts of a pair (x0, x1), packed as pack_bf16 packs
// them: hi = bf16(x), lo = bf16(x - hi), each rounded to nearest even.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s) : "memory");
}

// s[j] (keys 8j .. 8j + 7) = A[16][DP] . B[BK][DP]^T, A and B shared tiles
// with row stride LD. f32: the small terms go to their own accumulator,
// which halves the dependent chain of MMAs and is added at the end.
template <int DP, int BK, int LD>
__device__ __forceinline__ void score_product(float (&s)[BK / 8][4], const float* a_s,
                                              const float* b_s, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float cross[BK / 8][4];
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = cross[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    const int c = 8 * kk + t;
    uint32_t ah[4], al[4];
    split_tf32(a_s[g * LD + c], ah[0], al[0]);
    split_tf32(a_s[(g + 8) * LD + c], ah[1], al[1]);
    split_tf32(a_s[g * LD + c + 4], ah[2], al[2]);
    split_tf32(a_s[(g + 8) * LD + c + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      uint32_t bh[2], bl[2];
      split_tf32(b_s[(8 * j + g) * LD + c], bh[0], bl[0]);
      split_tf32(b_s[(8 * j + g) * LD + c + 4], bh[1], bl[1]);
      mma_tf32(cross[j], al, bh);
      mma_tf32(cross[j], ah, bl);
      mma_tf32(s[j], ah, bh);
    }
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += cross[j][e];
}

// Row and column of each of the four values of one lane's A fragment for
// k step kk of a [16][DP] operand, in the register order of mma.sync: (g,
// c), (g + 8, c), (g, c + 4), (g + 8, c + 4), c = 8 kk + t.
__device__ __forceinline__ void a_fragment_at(int kk, int lane, int (&r)[4], int (&c)[4]) {
  const int g = lane >> 2, c0 = 8 * kk + (lane & 3);
  r[0] = g, r[1] = g + 8, r[2] = g, r[3] = g + 8;
  c[0] = c0, c[1] = c0, c[2] = c0 + 4, c[3] = c0 + 4;
}

// The TF32 hi and lo parts of an A fragment's four values, as
// score_product splits them.
__device__ __forceinline__ void split_a_fragment(uint4& hi, uint4& lo, const float (&x)[4]) {
  split_tf32(x[0], hi.x, lo.x);
  split_tf32(x[1], hi.y, lo.y);
  split_tf32(x[2], hi.z, lo.z);
  split_tf32(x[3], hi.w, lo.w);
}

// score_product for an A operand split once: a_hi[kk * 32 + lane] and
// a_lo[kk * 32 + lane] hold split_a_fragment's parts of the values at
// a_fragment_at(kk, lane). The three TF32 products of each k step go into
// one accumulator, small terms first (as value_product's), which keeps
// fewer registers live than score_product's separate cross terms.
template <int DP, int BK, int LD>
__device__ __forceinline__ void score_product_split_a(float (&s)[BK / 8][4], const uint4* a_hi,
                                                      const uint4* a_lo, const float* b_s,
                                                      int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    const int c = 8 * kk + t;
    const uint4 h = a_hi[kk * 32 + lane], l = a_lo[kk * 32 + lane];
    const uint32_t ah[4] = {h.x, h.y, h.z, h.w};
    const uint32_t al[4] = {l.x, l.y, l.z, l.w};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      uint32_t bh[2], bl[2];
      split_tf32(b_s[(8 * j + g) * LD + c], bh[0], bl[0]);
      split_tf32(b_s[(8 * j + g) * LD + c + 4], bh[1], bl[1]);
      mma_3xtf32(s[j], ah, al, bh, bl);
    }
  }
}

template <int DP, int BK, int LD>
__device__ __forceinline__ void score_product(float (&s)[BK / 8][4], const __nv_bfloat16* a_s,
                                              const __nv_bfloat16* b_s, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int c = 16 * kk + 2 * t;
    uint32_t a[4];
    a[0] = ld_u32(a_s + g * LD + c);
    a[1] = ld_u32(a_s + (g + 8) * LD + c);
    a[2] = ld_u32(a_s + g * LD + c + 8);
    a[3] = ld_u32(a_s + (g + 8) * LD + c + 8);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      uint32_t b[2];
      b[0] = ld_u32(b_s + (8 * j + g) * LD + c);
      b[1] = ld_u32(b_s + (8 * j + g) * LD + c + 8);
      mma_bf16(s[j], a, b);
    }
  }
}

// o[n] (columns 8n .. 8n + 7) += P[16][BK] . B[BK][DP], P in
// score_product's accumulator layout, B a shared tile with row stride LD.
template <int DP, int BK, int LD>
__device__ __forceinline__ void value_product(float (&o)[DP / 8][4], const float (&p)[BK / 8][4],
                                              const float* b_s, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kb = 0; kb < BK / 8; ++kb) {
    // A column t is key 8kb + 2t, column t + 4 is key 8kb + 2t + 1.
    uint32_t ah[4], al[4];
    split_tf32(p[kb][0], ah[0], al[0]);
    split_tf32(p[kb][2], ah[1], al[1]);
    split_tf32(p[kb][1], ah[2], al[2]);
    split_tf32(p[kb][3], ah[3], al[3]);
    const float* r0 = b_s + (8 * kb + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      uint32_t bh[2], bl[2];
      split_tf32(r0[8 * n], bh[0], bl[0]);
      split_tf32(r0[LD + 8 * n], bh[1], bl[1]);
      mma_3xtf32(o[n], ah, al, bh, bl);
    }
  }
}

template <int DP, int BK, int LD>
__device__ __forceinline__ void value_product(float (&o)[DP / 8][4], const float (&p)[BK / 8][4],
                                              const __nv_bfloat16* b_s, int lane) {
  const int mi = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kb = 0; kb < BK / 16; ++kb) {
    uint32_t ah[4], al[4];
    split_bf16(p[2 * kb][0], p[2 * kb][1], ah[0], al[0]);
    split_bf16(p[2 * kb][2], p[2 * kb][3], ah[1], al[1]);
    split_bf16(p[2 * kb + 1][0], p[2 * kb + 1][1], ah[2], al[2]);
    split_bf16(p[2 * kb + 1][2], p[2 * kb + 1][3], ah[3], al[3]);
    // Lanes 8i .. 8i + 7 address matrix i: keys 16kb + (i & 1) * 8 + r,
    // columns 8 (n + (i >> 1)) ..; registers 0, 1 feed n, 2, 3 feed n + 1.
    const __nv_bfloat16* row = b_s + (16 * kb + (mi & 1) * 8 + r) * LD + 8 * (mi >> 1);
#pragma unroll
    for (int n = 0; n < DP / 8; n += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, row + 8 * n);
      mma_bf16(o[n], al, b);
      mma_bf16(o[n + 1], al, b + 2);
      mma_bf16(o[n], ah, b);
      mma_bf16(o[n + 1], ah, b + 2);
    }
  }
}

// A warp's walk over its key-tile stream tt, tt + step, ...: cand is the
// next tile to test and ks[i] this lane's key segment id (lane < BK) in
// tile cand + i * step, loaded W candidates ahead so that the loads'
// latency hides behind the tiles' work (and the first W go out together).
template <int W>
struct KeyStream {
  int cand;
  int ks[W];
};

template <int BK, typename Params>
__device__ __forceinline__ int load_key_seg(const Params& p, int tt, int bi, int lane) {
  const int k = tt * BK + lane;
  return p.qseg != nullptr && lane < BK && k < p.sk ? p.kseg[bi * p.sk + k] : 0;
}

template <int BK, int W, typename Params>
__device__ __forceinline__ KeyStream<W> key_stream(const Params& p, int first, int step, int bi,
                                                   int lane) {
  KeyStream<W> st;
  st.cand = first;
#pragma unroll
  for (int i = 0; i < W; ++i) st.ks[i] = load_key_seg<BK>(p, first + i * step, bi, lane);
  return st;
}

// Whether key tile tt (BK keys from tt * BK) holds an attendable pair for
// the block's query rows q0 .. q0 + nq - 1 (nq <= BQ): 1 live, 0 skip it,
// -1 stop (past the keys or the causal frontier: so is every later tile).
// ks is this lane's key segment id. Uniform over the warp; reads no K/V.
// Params carries the mask fields of the kernels' Params.
template <int BK, int BQ, typename Params>
__device__ __forceinline__ int tile_state(const Params& p, int tt, int q0, int nq,
                                          const int* qseg_s, int ks) {
  const int k0 = tt * BK;
  if (k0 >= p.sk) return -1;
  if (p.causal && k0 > q0 + nq - 1) return -1;
  const int kn = min(BK, p.sk - k0);
  if (p.has_window && !(q0 - (k0 + kn - 1) < p.window)) return 0;
  if (p.qseg != nullptr) {
    bool live = false;
    for (int r = 0; r < BQ; ++r) live |= r < nq && ks != 0 && ks == qseg_s[r];
    if (!__any_sync(kFull, live)) return 0;
  }
  return 1;
}

// The stream's next live tile, or -1; ks gets this lane's key segment id
// in it.
template <int BK, int BQ, int W, typename Params>
__device__ __forceinline__ int next_live_tile(const Params& p, KeyStream<W>& st, int step, int bi,
                                              int q0, int nq, const int* qseg_s, int lane,
                                              int& ks) {
  for (;;) {
    const int tt = st.cand;
    const int kst = st.ks[0];
    const int state = tile_state<BK, BQ>(p, tt, q0, nq, qseg_s, kst);
    if (state < 0) return -1;
    st.cand = tt + step;
#pragma unroll
    for (int i = 0; i + 1 < W; ++i) st.ks[i] = st.ks[i + 1];
    st.ks[W - 1] = load_key_seg<BK>(p, tt + W * step, bi, lane);
    if (state > 0) {
      ks = kst;
      return tt;
    }
  }
}

// Barrier over the `threads` threads (whole warps) that share key stream
// w's ring (w < 8): named barrier 1 + w (0 is __syncthreads'). Immediate
// ids, so a kernel reserves only the barriers it names.
__device__ __forceinline__ void stream_sync(int w, int threads) {
  switch (w) {
    case 0: asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory"); break;
    case 1: asm volatile("bar.sync 2, %0;\n" ::"r"(threads) : "memory"); break;
    case 2: asm volatile("bar.sync 3, %0;\n" ::"r"(threads) : "memory"); break;
    case 3: asm volatile("bar.sync 4, %0;\n" ::"r"(threads) : "memory"); break;
    case 4: asm volatile("bar.sync 5, %0;\n" ::"r"(threads) : "memory"); break;
    case 5: asm volatile("bar.sync 6, %0;\n" ::"r"(threads) : "memory"); break;
    case 6: asm volatile("bar.sync 7, %0;\n" ::"r"(threads) : "memory"); break;
    default: asm volatile("bar.sync 8, %0;\n" ::"r"(threads) : "memory"); break;
  }
}

// Whether query row qp may attend key kp (kp < sk), with ks the key's
// segment id and qs the row's.
template <typename Params>
__device__ __forceinline__ bool pair_live(const Params& p, int qp, int kp, int qs, int ks) {
  bool live = kp < p.sk;
  if (p.causal) live = live && qp >= kp;
  if (p.has_window) live = live && (qp - kp < p.window);
  if (p.qseg != nullptr) live = live && ks != 0 && ks == qs;
  return live;
}

}  // namespace
