// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel torch_actor_critic_tpu/ops/attention.py::_flash_kernel
// (launched by _flash_forward through pl.pallas_call). Same function: online-
// softmax attention over (batch, heads, T, d), optional causal mask, f32 running
// max / normaliser / accumulator, key tiles past the block's last row skipped,
// optional f32 per-row logsumexp for the backward. For bf16 inputs the
// probability tile is rounded to bf16 before P.V, as the TPU kernel's _acc_dot
// does; the normaliser sums the unrounded f32 probabilities.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 and 495 TF32 on the tensor cores,
// 3.35 TB/s):
//  - serving/training shape (64, 4, 16, 16) causal f32: ~1 MB moved and
//    ~2 MFLOP, a third of a microsecond either way: the launch and one
//    round trip to memory bound it. So one warp per (batch*head) of 16 rows,
//    four (batch*head) pairs per 128-thread block (64 blocks, every thread
//    busy), the key tile sized to the keys that exist (16, not 64), and q/k/v
//    read in place from the model's (B, T, H, d) views and o written in that
//    layout: one kernel per call, no copies around it.
//  - bench shape (4, 8, 2048, 64) causal: ~17 GFLOP, operations-bound. Both
//    products run on the tensor cores with mma.sync: bf16 as m16n8k16 with
//    f32 accumulation; f32 as m16n8k8 TF32 with 3xTF32 (each operand split
//    into a TF32 high part and a TF32 low part, three products hi.hi, hi.lo,
//    lo.hi), which keeps an f32 product's accuracy (the port's 1e-4 contract;
//    one TF32 pass errs by ~1e-3) at a third of the TF32 rate, 165 TFLOP/s.
//    Four warps (64 query rows of one batch*head) share each K/V tile, which
//    arrives in shared memory by cp.async, double-buffered so the next tile's
//    copy overlaps this tile's math. wgmma/TMA and warp specialisation are
//    later work: wgmma's 64-row M tile is four times a head's 16 rows on the
//    main path, and heads cannot share an M tile (each has its own K).
//
// Fragments (PTX mma layouts; lane = 4*g + t): the S = Q.K^T accumulator of an
// n8 key tile holds rows g and g+8, keys 2t and 2t+1. For bf16 two adjacent S
// tiles are the A operand of P.V directly (FlashAttention-2) and V is the B
// operand through ldmatrix.trans. For TF32 the A operand wants keys t and t+4
// of rows g and g+8, so P is re-laid with shuffles inside each 4-lane quad.
// Shared-memory rows are padded (K: d+4 f32 / d+8 bf16, V: d+8) so the
// fragment reads hit 32 distinct banks.
//
// Layout: q, o are (B, H, Tq, d) and k, v (B, H, Tk, d), each given by its
// base and 64-bit element strides over (batch, head, seq); the last dim is
// unit-stride, and bases and strides are 16-byte aligned (the wrapper copies
// an operand that is not). lse (optional) is (B, H, Tq) contiguous f32. Any
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
constexpr int kRows = 16;                       // query rows per warp: the mma M tile
constexpr int kBlockRows = kWarps * kRows;      // query rows per block, Tq > 16
constexpr size_t kPackedSmemLimit = 96 * 1024;  // else Tq <= 16 takes the shared-tile mode
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Strides {
  long long b, h, t;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  Strides sq, sk, sv, so;
  int bh, heads, tq, tk, bk, n_qtiles, causal;
  float scale_log2;  // softmax scale * log2(e): the kernel works in exp2
};

// Key-tile rows at most, and the padded shared-memory row of K and of V.
template <typename T, int D> struct Cfg;
template <int D> struct Cfg<float, D> {
  static constexpr int kBkMax = D == 128 ? 32 : 64;
  static constexpr int kKStride = D + 4;
  static constexpr int kVStride = D + 8;
};
template <int D> struct Cfg<__nv_bfloat16, D> {
  static constexpr int kBkMax = 64;
  static constexpr int kKStride = D + 8;
  static constexpr int kVStride = D + 8;
};

// kPacked (Tq <= 16): each warp is one (batch*head), stages its own K/V and
// syncs with __syncwarp only, so a warp past the last (batch*head) just
// leaves. Otherwise the block's four warps take 64 rows of one (batch*head)
// and share each K/V tile behind __syncthreads; every warp reaches every
// barrier, including warps whose rows lie past Tq.
template <typename T, int D, bool kPacked>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  using C = Cfg<T, D>;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int KS = C::kKStride, VS = C::kVStride;
  constexpr int NT = C::kBkMax / 8;             // n8 key tiles of S
  constexpr int ND = D / 8;                     // n8 head-dim tiles of O
  constexpr int kChunk = 16 / sizeof(T);        // elements per 16-byte copy
  constexpr int kRowChunks = D / kChunk;
  constexpr int kGroupThreads = kPacked ? 32 : kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;

  int bh, q0, q_last_group;
  if (kPacked) {
    bh = blockIdx.x * kWarps + warp;
    if (bh >= p.bh) return;
    q0 = 0;
    q_last_group = p.tq - 1;
  } else {
    bh = blockIdx.x / p.n_qtiles;
    // The heaviest causal tiles (last rows) launch first.
    const int qt = p.n_qtiles - 1 - blockIdx.x % p.n_qtiles;
    q0 = qt * kBlockRows + warp * kRows;
    q_last_group = min((qt + 1) * kBlockRows, p.tq) - 1;
  }
  const int b = bh / p.heads, h = bh % p.heads;
  const T* qb = static_cast<const T*>(p.q) + b * p.sq.b + h * p.sq.h;
  const T* kb = static_cast<const T*>(p.k) + b * p.sk.b + h * p.sk.h;
  const T* vb = static_cast<const T*>(p.v) + b * p.sv.b + h * p.sv.h;

  const int bk = p.bk;
  const int stages = p.tk > bk ? 2 : 1;
  const int tile_elems = bk * (KS + VS);
  T* region = reinterpret_cast<T*>(smem_raw) +
              (kPacked ? warp * stages * tile_elems : 0);
  const int gtid = kPacked ? lane : threadIdx.x;

  // Keys the group loads (its last row's causal limit) and keys this warp
  // computes with (its own last row's).
  const int k_stop = p.causal ? min(p.tk, q_last_group + 1) : p.tk;
  const int n_tiles = (k_stop + bk - 1) / bk;
  const int kend = q0 >= p.tq ? 0
                   : p.causal ? min(p.tk, min(q0 + kRows, p.tq))
                              : p.tk;
  const int r0 = q0 + g, r1 = q0 + g + 8;

  auto sync_group = [] {
    if (kPacked) __syncwarp(); else __syncthreads();
  };

  auto issue = [&](int tile) {
    T* ks = region + (tile & 1) * tile_elems;
    T* vs = ks + bk * KS;
    for (int idx = gtid; idx < bk * kRowChunks; idx += kGroupThreads) {
      const int r = idx / kRowChunks, c = (idx % kRowChunks) * kChunk;
      const int key = tile * bk + r;
      const bool ok = key < p.tk;
      const long long row = ok ? key : 0;
      cp_async16(ks + r * KS + c, kb + row * p.sk.t + c, ok);
      cp_async16(vs + r * VS + c, vb + row * p.sv.t + c, ok);
    }
    cp_async_commit();
  };

  // The first K/V copy is in flight while Q loads.
  issue(0);

  // Q as A fragments, once: TF32 hi/lo (f32) or packed bf16 pairs.
  using QFrag = std::conditional_t<kBf16, uint32_t[D / 16][4], uint32_t[D / 8][4]>;
  QFrag qh, ql;
  if constexpr (kBf16) {
    auto ld = [&](int r, int c) -> uint32_t {
      return r < p.tq ? *reinterpret_cast<const uint32_t*>(qb + r * p.sq.t + c) : 0u;
    };
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qh[kk][0] = ld(r0, 16 * kk + 2 * t);
      qh[kk][1] = ld(r1, 16 * kk + 2 * t);
      qh[kk][2] = ld(r0, 16 * kk + 8 + 2 * t);
      qh[kk][3] = ld(r1, 16 * kk + 8 + 2 * t);
    }
  } else {
    auto ld = [&](int r, int c) -> float { return r < p.tq ? qb[r * p.sq.t + c] : 0.f; };
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      split_tf32(ld(r0, 8 * kk + t), qh[kk][0], ql[kk][0]);
      split_tf32(ld(r1, 8 * kk + t), qh[kk][1], ql[kk][1]);
      split_tf32(ld(r0, 8 * kk + t + 4), qh[kk][2], ql[kk][2]);
      split_tf32(ld(r1, 8 * kk + t + 4), qh[kk][3], ql[kk][3]);
    }
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};              // this lane's share of the normaliser

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
      const T* ks = region + (it & 1) * tile_elems;
      const T* vs = ks + bk * KS;

      // S = Q.K^T on the tensor cores.
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        if (8 * j < bk && k0 + 8 * j < kend) {
          const T* kr = ks + (8 * j + g) * KS;
          if constexpr (kBf16) {
#pragma unroll
            for (int kk = 0; kk < D / 16; ++kk) {
              const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + 16 * kk + 2 * t);
              const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 16 * kk + 8 + 2 * t);
              mma_bf16(s[j], qh[kk], b0, b1);
            }
          } else {
#pragma unroll
            for (int kk = 0; kk < D / 8; ++kk) {
              uint32_t bh0, bl0, bh1, bl1;
              split_tf32(kr[8 * kk + t], bh0, bl0);
              split_tf32(kr[8 * kk + t + 4], bh1, bl1);
              mma_3xtf32(s[j], qh[kk], ql[kk], bh0, bh1, bl0, bl1);
            }
          }
        }
      }

      // Scale, mask (keys past Tk or past the row, tiles not computed), row max.
      const bool edge = k0 + bk > p.tk || (p.causal && k0 + bk - 1 > q0);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bool live = 8 * j < bk && k0 + 8 * j < kend;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int row = e < 2 ? r0 : r1;
          const bool hidden = !live || (edge && (key >= p.tk || (p.causal && key > row)));
          s[j][e] = hidden ? -INFINITY : s[j][e] * p.scale_log2;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      }
      float m_use[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float m_new = fmaxf(m[i], quad_max(mx[i]));
        // A row that has seen no key keeps m == -inf; exp2(-inf - 0) = 0
        // then leaves its state untouched instead of producing NaN.
        m_use[i] = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2f(m[i] - m_use[i]);
        l[i] *= alpha;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          acc[n][2 * i] *= alpha;
          acc[n][2 * i + 1] *= alpha;
        }
        m[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(s[j][e] - m_use[e >> 1]);
          l[e >> 1] += s[j][e];
        }
      }

      // O += P.V on the tensor cores.
      if constexpr (kBf16) {
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
          if (16 * kk < bk && k0 + 16 * kk < kend) {
            const uint32_t a[4] = {
                pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
            };
            const T* vr = vs + (16 * kk + (lane & 15)) * VS;
#pragma unroll
            for (int n = 0; n < ND; ++n) {
              uint32_t b0, b1;
              ldmatrix_x2_trans(b0, b1, vr + 8 * n);
              mma_bf16(acc[n], a, b0, b1);
            }
          }
        }
      } else {
        const int src = (lane & ~3) | (t >> 1);
        const bool odd = t & 1;
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
          if (8 * kk < bk && k0 + 8 * kk < kend) {
            // Keys t and t+4 of rows g and g+8, from the quad's S layout.
            float pv[4];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float x0 = __shfl_sync(0xffffffffu, s[kk][2 * i], src);
              const float x1 = __shfl_sync(0xffffffffu, s[kk][2 * i + 1], src);
              const float y0 = __shfl_sync(0xffffffffu, s[kk][2 * i], src + 2);
              const float y1 = __shfl_sync(0xffffffffu, s[kk][2 * i + 1], src + 2);
              pv[i] = odd ? x1 : x0;
              pv[i + 2] = odd ? y1 : y0;
            }
            uint32_t ah[4], al[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) split_tf32(pv[i], ah[i], al[i]);
            const T* vr = vs + (8 * kk + t) * VS + g;
#pragma unroll
            for (int n = 0; n < ND; ++n) {
              uint32_t bh0, bl0, bh1, bl1;
              split_tf32(vr[8 * n], bh0, bl0);
              split_tf32(vr[4 * VS + 8 * n], bh1, bl1);
              mma_3xtf32(acc[n], ah, al, bh0, bh1, bl0, bl1);
            }
          }
        }
      }
    }
    sync_group();  // this stage is consumed before the next copy overwrites it
  }

  T* ob = static_cast<T*>(p.o) + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? r1 : r0;
    const float lsum = quad_sum(l[i]);
    if (row >= p.tq) continue;
    const float inv = 1.f / (lsum == 0.f ? 1.f : lsum);
    T* orow = ob + row * p.so.t + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const float x0 = acc[n][2 * i] * inv, x1 = acc[n][2 * i + 1] * inv;
      if constexpr (kBf16) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) = __floats2bfloat162_rn(x0, x1);
      } else {
        *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(x0, x1);
      }
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[(long long)bh * p.tq + row] = lsum == 0.f ? -INFINITY : m[i] * kLn2 + logf(lsum);
    }
  }
}

template <typename T, int D, bool kPacked>
cudaError_t launch(const Params& p, unsigned grid, size_t smem, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, D, kPacked>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The key tile: min(kBkMax, Tk rounded up to 16); double-buffered when there
// is more than one. Tq <= 16 packs four (batch*head) pairs per block unless
// their four private tiles would pass kPackedSmemLimit.
template <typename T, int D>
cudaError_t plan(Params p, cudaStream_t stream) {
  using C = Cfg<T, D>;
  p.bk = std::min<int>(C::kBkMax, (p.tk + 15) / 16 * 16);
  const int stages = p.tk > p.bk ? 2 : 1;
  const size_t region =
      static_cast<size_t>(stages) * p.bk * (C::kKStride + C::kVStride) * sizeof(T);
  if (p.tq <= kRows && kWarps * region <= kPackedSmemLimit) {
    p.n_qtiles = 1;
    return launch<T, D, true>(p, (p.bh + kWarps - 1) / kWarps, kWarps * region, stream);
  }
  p.n_qtiles = (p.tq + kBlockRows - 1) / kBlockRows;
  const long long blocks = static_cast<long long>(p.bh) * p.n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  return launch<T, D, false>(p, static_cast<unsigned>(blocks), region, stream);
}

template <typename T>
cudaError_t dispatch_d(const Params& p, int d, cudaStream_t stream) {
  switch (d) {
    case 16: return plan<T, 16>(p, stream);
    case 32: return plan<T, 32>(p, stream);
    case 64: return plan<T, 64>(p, stream);
    case 128: return plan<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. d must be 16, 32, 64 or 128 (the wrapper
// zero-pads other head dims up to the next of these). Strides are in
// elements over (batch, head, seq); the head dim is unit-stride. lse may be
// null. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int tac_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, int batch, int heads, int tq, int tk, int d,
                             int dtype, int causal, float scale,
                             long long q_sb, long long q_sh, long long q_st,
                             long long k_sb, long long k_sh, long long k_st,
                             long long v_sb, long long v_sh, long long v_st,
                             long long o_sb, long long o_sh, long long o_st,
                             void* stream) {
  const long long bh = static_cast<long long>(batch) * heads;
  if (batch < 1 || heads < 1 || tq < 1 || tk < 1 || bh > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.sq = {q_sb, q_sh, q_st};
  p.sk = {k_sb, k_sh, k_st};
  p.sv = {v_sb, v_sh, v_st};
  p.so = {o_sb, o_sh, o_st};
  p.bh = static_cast<int>(bh);
  p.heads = heads;
  p.tq = tq;
  p.tk = tk;
  p.causal = causal;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_d<float>(p, d, s);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(p, d, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
