// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two TPU kernels of torch_actor_critic_tpu/ops/attention.py::
// _flash_backward (both launched through pl.pallas_call):
//  - tac_flash_bwd_dq  <- _flash_bwd_dq_kernel  (K3): Delta = rowsum(dO * O),
//                                                     dQ = sum_k ds K * scale
//  - tac_flash_bwd_dkv <- _flash_bwd_dkv_kernel (K4): dV = sum_q p^T dO,
//                                                     dK = sum_q ds^T Q * scale
// with p = exp(s - lse) recomputed from the forward's saved f32 logsumexp and
// ds = p * (dO.V^T - Delta). K3 computes Delta for its own rows in f32 (the
// JAX package computes it outside its kernels), uses it and writes it out;
// K4 runs after K3 on the same stream and reads it. No (Tq, Tk) matrix is
// ever written to device memory. For bf16 inputs every f32 intermediate that
// meets a bf16 operand is rounded to bf16 first (ds before .K and .Q, p before
// .dO), as the TPU kernels' _acc_dot does; accumulation is f32 throughout.
//
// Deterministic: one warp owns each output row and sums in a fixed order; no
// atomics, so two runs give bitwise-equal gradients.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 and 495 TF32 on the tensor cores,
// 3.35 TB/s):
//  - training shape (64, 4, 16, 16) causal f32: each kernel moves ~0.4 MB and
//    does ~1-2 MFLOP, a fraction of a microsecond either way: launch latency
//    bounds them. So K2's design (csrc/flash_fwd.cu): one warp owns 16 rows
//    (the mma M tile); with the owned side <= 16 rows each warp is one
//    (batch*head), four per 128-thread block, staging its own tiles and
//    syncing with __syncwarp; the streamed tile is sized to the rows that
//    exist (16, not 64); q, k, v, o and dO are read in place from the model's
//    (B, T, H, d) views and dq, dk, dv written in that layout, so one
//    backward is two kernels and the model's head split costs no copy.
//    Packed with a 16-row streamed tile, the kernel is compiled for those
//    two n8 tiles alone: on an H100 the kTileMax-wide build, six of its
//    eight tiles masked, was 1.4-1.6x slower there.
//  - bench shape (4, 8, 2048, 64) causal: ~26 GFLOP (K3) and ~34 GFLOP (K4),
//    operations-bound. Every product runs on the tensor cores with mma.sync:
//    bf16 as m16n8k16 with f32 accumulation, f32 as m16n8k8 3xTF32 into fresh
//    accumulators (165 TFLOP/s). An f32 operand is split with an AND and a
//    subtract (split_tf32_trunc), not two cvt: with cvt (quarter rate) or a
//    rounded split in f32 ops the splits outnumber the mma they feed. With
//    more rows four warps (64 owned rows of one batch*head) share each
//    streamed tile, copied by cp.async and double-buffered; tiles that
//    causality hides are never loaded, and only tiles on the diagonal or a
//    ragged edge are masked element by element.
//
// K3, one warp per 16 query rows, streams K/V tiles: S = Q.K^T and
// dP = dO.V^T (A = the warp's Q / dO rows, B = K / V rows as K2 reads K),
// dS = P o (dP - Delta), dQ += dS.K (A = dS from the accumulators, B = K
// through ldmatrix.trans or scalar loads, as K2 reads V).
// K4, one warp per 16 key rows, streams Q/dO tiles with their lse and Delta,
// and computes the transposed tiles so every A operand is its own rows or an
// accumulator (FlashAttention-2): S^T = K.Q^T, P^T = exp(S^T - lse[col]),
// dP^T = V.dO^T, dS^T = P^T o (dP^T - Delta[col]), dV += P^T.dO,
// dK += dS^T.Q. Key j is seen by query i iff j <= i under the causal mask.
// The A fragments are read from shared memory at each use, not held in
// registers: K4's f32 d = 128 would otherwise need ~400 registers.
//
// Layout: q, o, dO, dq are (B, H, Tq, d) and k, v, dk, dv (B, H, Tk, d), each
// given by its base and 64-bit element strides over (batch, head, seq); the
// last dim is unit-stride; q, k, v, dO are 16-byte aligned (the wrapper
// copies one that is not). lse and Delta are (B, H, Tq) contiguous f32. Any
// Tq, Tk >= 1: ragged tails are masked, zero-filled by cp.async.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "mma_sm90.cuh"

namespace {

using namespace tac;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;                       // owned rows per warp: the mma M tile
constexpr int kBlockRows = kWarps * kRows;      // owned rows per block, T > 16
constexpr size_t kPackedSmemLimit = 96 * 1024;  // else T <= 16 takes the shared-tile mode
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, h, t;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int bh, heads, tq, tk, tile, n_owned_tiles, causal;
  float scale, scale_log2;
};

// The padded shared-memory row (fragment reads hit distinct banks) and the
// streamed tile's rows at most.
template <typename T, int D> struct Cfg {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kStride = kBf16 ? D + 8 : D + 4;
  static constexpr int kTileMax = D == 128 ? 32 : 64;
  static constexpr int kChunk = 16 / sizeof(T);  // elements per 16-byte copy
  static constexpr int kRowChunks = D / kChunk;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// A row whose forward saw no key has lse = -inf; +inf makes its p = 0.
__device__ __forceinline__ float safe_lse(float lse) {
  return lse == -INFINITY ? INFINITY : lse;
}

// c[j] = A.X_j^T over the head dim for each live n8 tile j (bit j of
// `live`; dead tiles stay 0): A is this warp's 16 shared rows `a`, X_j rows
// 8j..8j+7 of the shared tile `x`.
template <typename T, int D, int NT>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], const T* a, const T* x,
                                        unsigned live, int g, int t) {
  constexpr int S = Cfg<T, D>::kStride;
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
  if constexpr (Cfg<T, D>::kBf16) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const T* ar = a + g * S + 16 * kk + 2 * t;
      const uint32_t af[4] = {ld32(ar), ld32(ar + 8 * S), ld32(ar + 8), ld32(ar + 8 * S + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (live >> j & 1u) {
          const T* xr = x + (8 * j + g) * S + 16 * kk + 2 * t;
          mma_bf16(c[j], af, ld32(xr), ld32(xr + 8));
        }
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const T* ar = a + g * S + 8 * kk + t;
      uint32_t ah[4], al[4];
      split_tf32_trunc(ar[0], ah[0], al[0]);
      split_tf32_trunc(ar[8 * S], ah[1], al[1]);
      split_tf32_trunc(ar[4], ah[2], al[2]);
      split_tf32_trunc(ar[8 * S + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (live >> j & 1u) {
          const T* xr = x + (8 * j + g) * S + 8 * kk + t;
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32_trunc(xr[0], bh0, bl0);
          split_tf32_trunc(xr[4], bh1, bl1);
          mma_3xtf32(c[j], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
  }
}

// acc += P.X: P is 16 x 8*NT in the accumulator layout (dead n8 tiles hold
// 0), X the shared tile whose rows are P's columns. bf16: two adjacent P
// tiles are the A operand as they lie (rounded to bf16), X the B operand
// through ldmatrix.trans. TF32: P re-laid to the A layout with shuffles
// inside each 4-lane quad, X read by scalar loads.
template <typename T, int D, int NT>
__device__ __forceinline__ void mma_px(float (&acc)[D / 8][4], const float (&pm)[NT][4],
                                       const T* x, unsigned live, int lane) {
  constexpr int S = Cfg<T, D>::kStride;
  const int g = lane >> 2, t = lane & 3;
  if constexpr (Cfg<T, D>::kBf16) {
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      if (live >> (2 * kk) & 3u) {
        const uint32_t a[4] = {
            pack_bf16(pm[2 * kk][0], pm[2 * kk][1]),
            pack_bf16(pm[2 * kk][2], pm[2 * kk][3]),
            pack_bf16(pm[2 * kk + 1][0], pm[2 * kk + 1][1]),
            pack_bf16(pm[2 * kk + 1][2], pm[2 * kk + 1][3]),
        };
        const T* xr = x + (16 * kk + (lane & 15)) * S;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, xr + 8 * n);
          mma_bf16(acc[n], a, b0, b1);
        }
      }
    }
  } else {
    const int src = (lane & ~3) | (t >> 1);
    const bool odd = t & 1;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      if (live >> kk & 1u) {
        // Columns t and t+4 of rows g and g+8, from the quad's C layout.
        float pv[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float x0 = __shfl_sync(kFull, pm[kk][2 * i], src);
          const float x1 = __shfl_sync(kFull, pm[kk][2 * i + 1], src);
          const float y0 = __shfl_sync(kFull, pm[kk][2 * i], src + 2);
          const float y1 = __shfl_sync(kFull, pm[kk][2 * i + 1], src + 2);
          pv[i] = odd ? x1 : x0;
          pv[i + 2] = odd ? y1 : y0;
        }
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32_trunc(pv[i], ah[i], al[i]);
        const T* xr = x + (8 * kk + t) * S + g;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32_trunc(xr[8 * n], bh0, bl0);
          split_tf32_trunc(xr[4 * S + 8 * n], bh1, bl1);
          mma_3xtf32(acc[n], ah, al, bh0, bh1, bl0, bl1);
        }
      }
    }
  }
}

// Copy rows [row0, row0 + rows) of two (T_len, D) operands, each given by
// its base and row stride, into shared tiles of kStride; zero past t_len.
template <typename T, int D>
__device__ __forceinline__ void copy_rows(T* xs, T* ys, const T* x, long long sx,
                                          const T* y, long long sy, int row0, int rows,
                                          int t_len, int tid, int n_threads) {
  using C = Cfg<T, D>;
  for (int idx = tid; idx < rows * C::kRowChunks; idx += n_threads) {
    const int r = idx / C::kRowChunks, c = (idx % C::kRowChunks) * C::kChunk;
    const int row = row0 + r;
    const bool ok = row < t_len;
    const long long rr = ok ? row : 0;
    cp_async16(xs + r * C::kStride + c, x + rr * sx + c, ok);
    cp_async16(ys + r * C::kStride + c, y + rr * sy + c, ok);
  }
}

// Write this warp's rows g and g+8 (row0 + ...) of acc * mul, where < t_len.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, long long st, const float (&acc)[D / 8][4],
                                           float mul, int row0, int t_len, int g, int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= t_len) continue;
    T* r = base + row * st + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) store2(r + 8 * n, acc[n][2 * i] * mul, acc[n][2 * i + 1] * mul);
  }
}

// kPacked (owned side <= 16 rows): each warp is one (batch*head), stages its
// own tiles and syncs with __syncwarp only, so a warp past the last
// (batch*head) just leaves. Otherwise the block's four warps own 64 rows of
// one (batch*head) and share each streamed tile behind __syncthreads; every
// warp reaches every barrier, including warps whose rows lie past T.

// K3. Shared memory per group: its Q and dO rows, then the K/V stages.
template <typename T, int D, bool kPacked, int NT>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const Params p) {
  using C = Cfg<T, D>;
  constexpr int S = C::kStride;
  constexpr int kGroupRows = kPacked ? kRows : kBlockRows;
  constexpr int kGroupThreads = kPacked ? 32 : kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  int bh, qg0;
  if (kPacked) {
    bh = blockIdx.x * kWarps + warp;
    if (bh >= p.bh) return;
    qg0 = 0;
  } else {
    bh = blockIdx.x / p.n_owned_tiles;
    // The heaviest causal tiles (last rows) launch first.
    qg0 = (p.n_owned_tiles - 1 - blockIdx.x % p.n_owned_tiles) * kBlockRows;
  }
  const int q0 = qg0 + (kPacked ? 0 : warp * kRows);
  const int q_last_group = min(qg0 + kGroupRows, p.tq) - 1;
  const int b = bh / p.heads, h = bh % p.heads;
  const T* qb = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* kb = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vb = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  const T* ob = static_cast<const T*>(p.o) + b * p.so.b + h * p.so.h;
  const T* dob = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;

  const int bk = p.tile;
  const int stages = p.tk > bk ? 2 : 1;
  const int tile_elems = 2 * bk * S;
  const int own_elems = 2 * kGroupRows * S;
  T* region = reinterpret_cast<T*>(smem_raw) +
              (kPacked ? warp * (own_elems + stages * tile_elems) : 0);
  T* qs = region;
  T* dos = qs + kGroupRows * S;
  T* tiles = region + own_elems;
  const int gtid = kPacked ? lane : threadIdx.x;

  // Keys the group loads (its last row's causal limit) and keys this warp
  // computes with (its own last row's).
  const bool causal = p.causal != 0;
  const int k_stop = causal ? min(p.tk, q_last_group + 1) : p.tk;
  const int n_tiles = (k_stop + bk - 1) / bk;
  const int kend = q0 >= p.tq ? 0
                   : causal ? min(p.tk, min(q0 + kRows, p.tq))
                            : p.tk;

  auto sync_group = [] {
    if (kPacked) __syncwarp(); else __syncthreads();
  };
  auto issue = [&](int tile) {
    T* ks = tiles + (tile & 1) * tile_elems;
    copy_rows<T, D>(ks, ks + bk * S, kb, p.sk.t, vb, p.sv.t, tile * bk, bk, p.tk, gtid,
                    kGroupThreads);
    cp_async_commit();
  };

  // The group's Q and dO rows travel with the first K/V tile.
  copy_rows<T, D>(qs, dos, qb, p.sq.t, dob, p.sdo.t, qg0, kGroupRows, p.tq, gtid,
                  kGroupThreads);
  issue(0);

  // Delta = rowsum(dO * O) of this warp's rows in f32, while the copies fly:
  // lanes l and l + 16 take the two halves of row q0 + l % 16.
  float dl[2];
  {
    const int row = q0 + (lane & 15);
    float part = 0.f;
    if (row < p.tq) {
      const T* orow = ob + row * p.so.t + (lane >> 4) * (D / 2);
      const T* drow = dob + row * p.sdo.t + (lane >> 4) * (D / 2);
#pragma unroll 8
      for (int c = 0; c < D / 2; ++c) part = fmaf(to_float(drow[c]), to_float(orow[c]), part);
    }
    part += __shfl_xor_sync(kFull, part, 16);
    if (lane < 16 && row < p.tq) p.delta[static_cast<long long>(bh) * p.tq + row] = part;
    dl[0] = __shfl_sync(kFull, part, g);
    dl[1] = __shfl_sync(kFull, part, g + 8);
  }
  const int r0 = q0 + g, r1 = r0 + 8;
  float lse2[2];  // log2 units; +inf past Tq, so p = 0 there
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? r1 : r0;
    lse2[i] = row < p.tq ? safe_lse(p.lse[static_cast<long long>(bh) * p.tq + row]) * kLog2e
                         : INFINITY;
  }
  const T* qw = qs + (q0 - qg0) * S;
  const T* dow = dos + (q0 - qg0) * S;

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      issue(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    sync_group();
    const int k0 = it * bk;
    if (k0 < kend) {
      const T* ks = tiles + (it & 1) * tile_elems;
      const T* vs = ks + bk * S;
      unsigned live = 0;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (8 * j < bk && k0 + 8 * j < kend) live |= 1u << j;
      }
      float s[NT][4], dp[NT][4];
      mma_abt<T, D, NT>(s, qw, ks, live, g, t);
      mma_abt<T, D, NT>(dp, dow, vs, live, g, t);
      // p from the saved lse; ds = p * (dp - Delta) into s. Only a tile
      // with keys past Tk or past a row of this warp is masked.
      const bool edge = k0 + bk > p.tk || (causal && k0 + bk - 1 > q0);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int i = e >> 1;
          // Bitwise, not short-circuit: no branch per element.
          const bool hidden = !(live >> j & 1u) |
                              (edge & ((key >= p.tk) | (causal & (key > (i ? r1 : r0)))));
          const float pr = hidden ? 0.f : exp2f(fmaf(s[j][e], p.scale_log2, -lse2[i]));
          s[j][e] = pr * (dp[j][e] - dl[i]);
        }
      }
      mma_px<T, D, NT>(acc, s, ks, live, lane);
    }
    sync_group();  // this stage is consumed before the next copy overwrites it
  }

  T* dqb = static_cast<T*>(p.dq) + b * p.sdq.b + h * p.sdq.h;
  store_rows<T, D>(dqb, p.sdq.t, acc, p.scale, q0, p.tq, g, t);
}

// K4. Shared memory per group: its K and V rows, then the stages, each Q,
// dO, and the f32 lse (log2 units) and Delta of those query rows.
template <typename T, int D, bool kPacked, int NT>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const Params p) {
  using C = Cfg<T, D>;
  constexpr int S = C::kStride;
  constexpr int kGroupRows = kPacked ? kRows : kBlockRows;
  constexpr int kGroupThreads = kPacked ? 32 : kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  int bh, kg0;
  if (kPacked) {
    bh = blockIdx.x * kWarps + warp;
    if (bh >= p.bh) return;
    kg0 = 0;
  } else {
    // The heaviest causal tiles (first keys) launch first.
    bh = blockIdx.x / p.n_owned_tiles;
    kg0 = (blockIdx.x % p.n_owned_tiles) * kBlockRows;
  }
  const int k0w = kg0 + (kPacked ? 0 : warp * kRows);
  const int b = bh / p.heads, h = bh % p.heads;
  const T* qb = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* kb = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vb = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;
  const T* dob = static_cast<const T*>(p.dout) + b * p.sdo.b + h * p.sdo.h;
  const float* lseb = p.lse + static_cast<long long>(bh) * p.tq;
  const float* deltab = p.delta + static_cast<long long>(bh) * p.tq;

  const int bq = p.tile;
  const int stages = p.tq > bq ? 2 : 1;
  const int own_bytes = 2 * kGroupRows * S * static_cast<int>(sizeof(T));
  const int stage_bytes = 2 * bq * S * static_cast<int>(sizeof(T)) + 2 * bq * 4;
  unsigned char* region = smem_raw + (kPacked ? warp * (own_bytes + stages * stage_bytes) : 0);
  T* ks = reinterpret_cast<T*>(region);
  T* vs = ks + kGroupRows * S;
  unsigned char* tiles = region + own_bytes;
  const int gtid = kPacked ? lane : threadIdx.x;

  // Causal: queries before the group's first key see none of its keys.
  const bool causal = p.causal != 0;
  const int q_begin = causal ? kg0 : 0;
  const int n_tiles = q_begin < p.tq ? (p.tq - q_begin + bq - 1) / bq : 0;

  auto sync_group = [] {
    if (kPacked) __syncwarp(); else __syncthreads();
  };
  auto q_tile = [&](int it) { return reinterpret_cast<T*>(tiles + (it & 1) * stage_bytes); };
  auto issue = [&](int it) {
    T* qt = q_tile(it);
    T* dot = qt + bq * S;
    float* ls = reinterpret_cast<float*>(dot + bq * S);
    const int q0 = q_begin + it * bq;
    copy_rows<T, D>(qt, dot, qb, p.sq.t, dob, p.sdo.t, q0, bq, p.tq, gtid, kGroupThreads);
    cp_async_commit();
    for (int r = gtid; r < bq; r += kGroupThreads) {
      const bool ok = q0 + r < p.tq;
      ls[r] = ok ? safe_lse(lseb[q0 + r]) * kLog2e : INFINITY;
      ls[bq + r] = ok ? deltab[q0 + r] : 0.f;
    }
  };

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  if (n_tiles > 0) {
    // The group's K and V rows travel with the first Q/dO tile.
    copy_rows<T, D>(ks, vs, kb, p.sk.t, vb, p.sv.t, kg0, kGroupRows, p.tk, gtid,
                    kGroupThreads);
    issue(0);
  }
  const T* kw = ks + (k0w - kg0) * S;
  const T* vw = vs + (k0w - kg0) * S;
  const int kr0 = k0w + g, kr1 = kr0 + 8;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      issue(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    sync_group();
    const int q0 = q_begin + it * bq;
    unsigned live = 0;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int qj = q0 + 8 * j;
      if (8 * j < bq && qj < p.tq && k0w < p.tk && (!causal || qj + 7 >= k0w)) {
        live |= 1u << j;
      }
    }
    if (live) {
      const T* qt = q_tile(it);
      const T* dot = qt + bq * S;
      const float* ls = reinterpret_cast<const float*>(dot + bq * S);
      float s[NT][4], dp[NT][4];  // S^T, dP^T: rows are keys, columns queries
      mma_abt<T, D, NT>(s, kw, qt, live, g, t);
      mma_abt<T, D, NT>(dp, vw, dot, live, g, t);
      // Only a tile with queries past Tq, keys past Tk or a key after a
      // query is masked.
      const bool edge = q0 + bq > p.tq || k0w + kRows > p.tk ||
                        (causal && q0 < k0w + kRows - 1);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // lse and Delta of this lane's two columns (a dead tile past the
        // stage reads the stage's last columns, and is masked).
        const int c = min(8 * j, bq - 8) + 2 * t;
        const float2 lc = *reinterpret_cast<const float2*>(ls + c);
        const float2 dc = *reinterpret_cast<const float2*>(ls + bq + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int query = q0 + 8 * j + 2 * t + (e & 1);
          const int key = e < 2 ? kr0 : kr1;
          const bool hidden =
              !(live >> j & 1u) |
              (edge & ((query >= p.tq) | (key >= p.tk) | (causal & (key > query))));
          const float pr =
              hidden ? 0.f : exp2f(fmaf(s[j][e], p.scale_log2, -(e & 1 ? lc.y : lc.x)));
          s[j][e] = pr;
          dp[j][e] = pr * (dp[j][e] - (e & 1 ? dc.y : dc.x));
        }
      }
      mma_px<T, D, NT>(dv, s, dot, live, lane);
      mma_px<T, D, NT>(dk, dp, qt, live, lane);
    }
    sync_group();  // this stage is consumed before the next copy overwrites it
  }

  T* dkb = static_cast<T*>(p.dk) + b * p.sdk.b + h * p.sdk.h;
  T* dvb = static_cast<T*>(p.dv) + b * p.sdv.b + h * p.sdv.h;
  store_rows<T, D>(dkb, p.sdk.t, dk, p.scale, k0w, p.tk, g, t);
  store_rows<T, D>(dvb, p.sdv.t, dv, 1.f, k0w, p.tk, g, t);
}

template <typename T, int D, bool kPacked, int NT, bool kDq>
cudaError_t launch(const Params& p, unsigned grid, size_t smem, cudaStream_t stream) {
  auto kernel = kDq ? flash_bwd_dq_kernel<T, D, kPacked, NT>
                    : flash_bwd_dkv_kernel<T, D, kPacked, NT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The streamed tile: min(kTileMax, its length rounded up to 16);
// double-buffered when there is more than one. An owned side <= 16 rows
// packs four (batch*head) pairs per block unless their four private regions
// would pass kPackedSmemLimit; packed with a 16-row streamed tile (the main
// path) the kernel is compiled for those two n8 tiles alone, not kTileMax/8
// of which six would be masked.
template <typename T, int D, bool kDq>
cudaError_t plan(Params p, cudaStream_t stream) {
  using C = Cfg<T, D>;
  const int owned = kDq ? p.tq : p.tk;
  const int streamed = kDq ? p.tk : p.tq;
  p.tile = std::min<int>(C::kTileMax, (streamed + 15) / 16 * 16);
  const size_t stages = streamed > p.tile ? 2 : 1;
  const size_t per_stage =
      2 * static_cast<size_t>(p.tile) * C::kStride * sizeof(T) + (kDq ? 0 : 2 * p.tile * 4);
  auto region = [&](int rows) {
    return 2 * static_cast<size_t>(rows) * C::kStride * sizeof(T) + stages * per_stage;
  };
  if (owned <= kRows && kWarps * region(kRows) <= kPackedSmemLimit) {
    p.n_owned_tiles = 1;
    const unsigned grid = (p.bh + kWarps - 1) / kWarps;
    if (p.tile == 16) return launch<T, D, true, 2, kDq>(p, grid, kWarps * region(kRows), stream);
    return launch<T, D, true, C::kTileMax / 8, kDq>(p, grid, kWarps * region(kRows), stream);
  }
  p.n_owned_tiles = (owned + kBlockRows - 1) / kBlockRows;
  const long long blocks = static_cast<long long>(p.bh) * p.n_owned_tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  return launch<T, D, false, C::kTileMax / 8, kDq>(p, static_cast<unsigned>(blocks),
                                                  region(kBlockRows), stream);
}

template <typename T, bool kDq>
cudaError_t dispatch_d(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return plan<T, 16, kDq>(p, stream);
    case 32: return plan<T, 32, kDq>(p, stream);
    case 64: return plan<T, 64, kDq>(p, stream);
    case 128: return plan<T, 128, kDq>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <bool kDq>
int run(Params& p, int batch, int heads, int tq, int tk, int d, int dtype, int causal,
        float scale, void* stream) {
  const long long bh = static_cast<long long>(batch) * heads;
  if (batch < 1 || heads < 1 || tq < 1 || tk < 1 || bh > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16(p.q) || !aligned16(p.k) || !aligned16(p.v) || !aligned16(p.dout)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  p.bh = static_cast<int>(bh);
  p.heads = heads;
  p.tq = tq;
  p.tk = tk;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_d<float, kDq>(p, d, s);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16, kDq>(p, d, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. d must be 16, 32, 64 or 128 (the wrapper
// zero-pads other head dims up to the next of these, o and dO included).
// Strides are in elements over (batch, head, seq); the head dim is
// unit-stride. Each entry point returns cudaGetLastError() after its launch
// (0 = launched).
//
// K3: writes dq and delta ((B, H, Tq) f32, Delta = rowsum(dO * O)).
extern "C" int tac_flash_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                                const void* dout, const void* lse, void* delta, void* dq,
                                int batch, int heads, int tq, int tk, int d, int dtype,
                                int causal, float scale,
                                long long q_sb, long long q_sh, long long q_st,
                                long long k_sb, long long k_sh, long long k_st,
                                long long v_sb, long long v_sh, long long v_st,
                                long long o_sb, long long o_sh, long long o_st,
                                long long do_sb, long long do_sh, long long do_st,
                                long long dq_sb, long long dq_sh, long long dq_st,
                                void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq;
  p.sq = {q_sb, q_sh, q_st};
  p.sk = {k_sb, k_sh, k_st};
  p.sv = {v_sb, v_sh, v_st};
  p.so = {o_sb, o_sh, o_st};
  p.sdo = {do_sb, do_sh, do_st};
  p.sdq = {dq_sb, dq_sh, dq_st};
  return run<true>(p, batch, heads, tq, tk, d, dtype, causal, scale, stream);
}

// K4: reads the delta K3 wrote; writes dk and dv.
extern "C" int tac_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, int batch, int heads, int tq, int tk,
                                 int d, int dtype, int causal, float scale,
                                 long long q_sb, long long q_sh, long long q_st,
                                 long long k_sb, long long k_sh, long long k_st,
                                 long long v_sb, long long v_sh, long long v_st,
                                 long long do_sb, long long do_sh, long long do_st,
                                 long long dk_sb, long long dk_sh, long long dk_st,
                                 long long dv_sb, long long dv_sh, long long dv_st,
                                 void* stream) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = const_cast<float*>(static_cast<const float*>(delta));
  p.dk = dk;
  p.dv = dv;
  p.sq = {q_sb, q_sh, q_st};
  p.sk = {k_sb, k_sh, k_st};
  p.sv = {v_sb, v_sh, v_st};
  p.sdo = {do_sb, do_sh, do_st};
  p.sdk = {dk_sb, dk_sh, dk_st};
  p.sdv = {dv_sb, dv_sh, dv_st};
  return run<false>(p, batch, heads, tq, tk, d, dtype, causal, scale, stream);
}
