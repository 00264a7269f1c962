// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the two TPU kernels of torch_actor_critic_tpu/ops/attention.py::
// _flash_backward (both launched through pl.pallas_call):
//  - tac_flash_bwd_dq  <- _flash_bwd_dq_kernel  (K3): dQ = sum_k ds K * scale
//  - tac_flash_bwd_dkv <- _flash_bwd_dkv_kernel (K4): dV = sum_q p^T dO,
//                                                     dK = sum_q ds^T Q * scale
// with p = exp(s - lse) recomputed from the forward's saved f32 logsumexp,
// ds = p * (dO.V^T - Delta), Delta = rowsum(dO * O) precomputed by the wrapper
// (as the JAX package computes it outside its kernels). No (Tq, Tk) matrix is
// ever written to device memory. For bf16 inputs every f32 intermediate that
// meets a bf16 operand is rounded to bf16 first (ds before .K and .Q, p before
// .dO), as the TPU kernels' _acc_dot does; accumulation is f32 throughout.
//
// Deterministic: one thread owns each output element and sums in a fixed order;
// no atomics, so two runs give bitwise-equal gradients.
//
// Bound on an H100 SXM (67 TFLOP/s f32 outside the tensor cores, 989 bf16
// tensor, 3.35 TB/s):
//  - training shape (64, 4, 16, 16) causal: dQ does three products (s, dO.V^T,
//    ds.K), 6*BH*Tq*Tk*d FLOPs halved by causality = ~1.6 MFLOP; dK/dV does
//    four, ~2.1 MFLOP; each moves ~0.7 MB. Both are far under a microsecond
//    of either resource, so launch overhead bounds them: the design keeps each
//    to ONE launch per layer and backward, with no extra host-side passes.
//  - bench shape (4, 8, 2048, 64) causal: ~26 GFLOP (dQ) and ~34 GFLOP (dK/dV),
//    operations-bound. This first version runs the products on the f32 CUDA
//    cores, so its floor is the 67 TFLOP/s f32 rate (the tensor cores, wgmma
//    and a fused one-pass backward are later work). What it does about the
//    bound: the streamed tile (K/V for dQ, Q/dO for dK/dV) is staged once per
//    block in shared memory and read as float4 (4 FMAs per shared load, the 8
//    rows of a warp sharing each address); tiles that causality hides are
//    never loaded (k tiles past the diagonal for dQ, q tiles before the k tile
//    for dK/dV).
//
// Layout: q, dout, dq are (BH, Tq, D); k, v, dk, dv are (BH, Tk, D); all
// contiguous, one dtype. lse and delta are (BH, Tq) f32. Any Tq/Tk >= 1: the
// ragged tail is masked. Thread layout as in flash_fwd.cu: 4 threads per owned
// row (a query row for dQ, a key row for dK/dV), each holding D/4 head dims as
// float4 chunks (dims c*16 + lane*4 .. +3); a row's partial dot products are
// summed with two xor-shuffles inside its 4-lane group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 32;  // rows owned by one block (q rows or k rows)
constexpr int kLanesPerRow = 4;    // threads sharing one owned row
constexpr int kThreads = kRowsPerBlock * kLanesPerRow;

// Rows of the streamed operand staged per shared-memory tile.
template <int D> struct TileRows { static constexpr int value = D <= 64 ? 64 : 32; };

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// An f32 intermediate as a product with a T operand sees it: unchanged for
// f32 inputs, rounded to bf16 for bf16 inputs (the TPU kernels' _acc_dot).
__device__ __forceinline__ float operand(float x, float) { return x; }
__device__ __forceinline__ float operand(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// A row whose forward saw no key has lse = -inf; +inf makes its p = 0.
__device__ __forceinline__ float safe_lse(float lse) {
  return lse == -INFINITY ? INFINITY : lse;
}

// Partial dot product of this thread's D/4 dims of `reg` with a shared row.
template <int kChunks>
__device__ __forceinline__ float dot_part(const float* reg, const float* srow, int lane) {
  float part = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(&srow[c * 16 + lane * 4]);
    part = fmaf(reg[c * 4 + 0], x.x, part);
    part = fmaf(reg[c * 4 + 1], x.y, part);
    part = fmaf(reg[c * 4 + 2], x.z, part);
    part = fmaf(reg[c * 4 + 3], x.w, part);
  }
  return part;
}

// acc += w * (this thread's D/4 dims of a shared row)
template <int kChunks>
__device__ __forceinline__ void axpy(float* acc, float w, const float* srow, int lane) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(&srow[c * 16 + lane * 4]);
    acc[c * 4 + 0] = fmaf(w, x.x, acc[c * 4 + 0]);
    acc[c * 4 + 1] = fmaf(w, x.y, acc[c * 4 + 1]);
    acc[c * 4 + 2] = fmaf(w, x.z, acc[c * 4 + 2]);
    acc[c * 4 + 3] = fmaf(w, x.w, acc[c * 4 + 3]);
  }
}

template <typename T, int kChunks>
__device__ __forceinline__ void load_row(float* reg, const T* src, bool valid, int lane) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    float4 x = valid ? load4(src + c * 16 + lane * 4) : make_float4(0.f, 0.f, 0.f, 0.f);
    reg[c * 4 + 0] = x.x; reg[c * 4 + 1] = x.y;
    reg[c * 4 + 2] = x.z; reg[c * 4 + 3] = x.w;
  }
}

template <typename T, int kChunks>
__device__ __forceinline__ void store_row(T* dst, const float* reg, float mul, int lane) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    store4(dst + c * 16 + lane * 4,
           make_float4(reg[c * 4 + 0] * mul, reg[c * 4 + 1] * mul,
                       reg[c * 4 + 2] * mul, reg[c * 4 + 3] * mul));
  }
}

// Stage rows [r0, r0 + R) of two (T_len, D) operands into shared memory as
// f32, zero past T_len.
template <typename T, int R, int D>
__device__ __forceinline__ void stage2(float (*a_s)[D], float (*b_s)[D],
                                       const T* a, const T* b, int r0, int t_len,
                                       int tid) {
  for (int idx = tid; idx < R * D / 4; idx += kThreads) {
    const int r = idx / (D / 4);
    const int col = (idx % (D / 4)) * 4;
    const int rr = r0 + r;
    float4 ax = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 bx = ax;
    if (rr < t_len) {
      ax = load4(a + (size_t)rr * D + col);
      bx = load4(b + (size_t)rr * D + col);
    }
    store4(&a_s[r][col], ax);
    store4(&b_s[r][col], bx);
  }
}

// K3: one block per (batch*head, 32-row q tile); loop over k tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int tq, int tk, int n_qtiles, float scale,
                    int causal) {
  constexpr int BK = TileRows<D>::value;
  constexpr int kChunks = D / (4 * kLanesPerRow);
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int bh = blockIdx.x / n_qtiles;
  const int qt = blockIdx.x % n_qtiles;
  const int tid = threadIdx.x;
  const int row = tid / kLanesPerRow;
  const int lane = tid % kLanesPerRow;
  const int qi = qt * kRowsPerBlock + row;
  const bool row_valid = qi < tq;

  const size_t qrow = (size_t)bh * tq + qi;
  const T* kb = k + (size_t)bh * tk * D;
  const T* vb = v + (size_t)bh * tk * D;

  float qr[kChunks * 4], dor[kChunks * 4], acc[kChunks * 4];
  load_row<T, kChunks>(qr, q + qrow * D, row_valid, lane);
  load_row<T, kChunks>(dor, dout + qrow * D, row_valid, lane);
#pragma unroll
  for (int i = 0; i < kChunks * 4; ++i) acc[i] = 0.f;
  const float row_lse = row_valid ? safe_lse(lse[qrow]) : 0.f;
  const float row_delta = row_valid ? delta[qrow] : 0.f;

  // Causal: keys past the tile's last row are never seen; skip their tiles.
  const int q_last = min((qt + 1) * kRowsPerBlock, tq) - 1;
  const int k_stop = causal ? min(tk, q_last + 1) : tk;

  for (int k0 = 0; k0 < k_stop; k0 += BK) {
    __syncthreads();  // the previous tile is fully consumed
    stage2<T, BK, D>(ks, vs, kb, vb, k0, tk, tid);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float s = dot_part<kChunks>(qr, ks[j], lane);
      float dpv = dot_part<kChunks>(dor, vs[j], lane);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dpv += __shfl_xor_sync(0xffffffffu, dpv, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dpv += __shfl_xor_sync(0xffffffffu, dpv, 2);
      const int kk = k0 + j;
      const bool ok = row_valid && kk < tk && (!causal || kk <= qi);
      const float p = ok ? expf(s * scale - row_lse) : 0.f;
      const float ds = p * (dpv - row_delta);
      axpy<kChunks>(acc, operand(ds, T()), ks[j], lane);
    }
  }
  if (row_valid) store_row<T, kChunks>(dq + qrow * D, acc, scale, lane);
}

// K4: one block per (batch*head, 32-row k tile); loop over q tiles.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int tq, int tk,
                     int n_ktiles, float scale, int causal) {
  constexpr int BQ = TileRows<D>::value;
  constexpr int kChunks = D / (4 * kLanesPerRow);
  __shared__ __align__(16) float qs[BQ][D];
  __shared__ __align__(16) float dos[BQ][D];
  __shared__ float lse_s[BQ];
  __shared__ float delta_s[BQ];

  const int bh = blockIdx.x / n_ktiles;
  const int kt = blockIdx.x % n_ktiles;
  const int tid = threadIdx.x;
  const int row = tid / kLanesPerRow;
  const int lane = tid % kLanesPerRow;
  const int kj = kt * kRowsPerBlock + row;
  const bool row_valid = kj < tk;

  const size_t krow = (size_t)bh * tk + kj;
  const T* qb = q + (size_t)bh * tq * D;
  const T* db = dout + (size_t)bh * tq * D;
  const float* lb = lse + (size_t)bh * tq;
  const float* deb = delta + (size_t)bh * tq;

  float kr[kChunks * 4], vr[kChunks * 4], dk_acc[kChunks * 4], dv_acc[kChunks * 4];
  load_row<T, kChunks>(kr, k + krow * D, row_valid, lane);
  load_row<T, kChunks>(vr, v + krow * D, row_valid, lane);
#pragma unroll
  for (int i = 0; i < kChunks * 4; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  // Causal: query rows before this tile's first key see none of it; start at
  // the q tile that holds that key.
  const int q_start = causal ? (kt * kRowsPerBlock / BQ) * BQ : 0;

  for (int q0 = q_start; q0 < tq; q0 += BQ) {
    __syncthreads();
    stage2<T, BQ, D>(qs, dos, qb, db, q0, tq, tid);
    for (int r = tid; r < BQ; r += kThreads) {
      const int qq = q0 + r;
      lse_s[r] = qq < tq ? safe_lse(lb[qq]) : 0.f;
      delta_s[r] = qq < tq ? deb[qq] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < BQ; ++i) {
      float s = dot_part<kChunks>(kr, qs[i], lane);
      float dpv = dot_part<kChunks>(vr, dos[i], lane);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dpv += __shfl_xor_sync(0xffffffffu, dpv, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dpv += __shfl_xor_sync(0xffffffffu, dpv, 2);
      const int qq = q0 + i;
      const bool ok = row_valid && qq < tq && (!causal || kj <= qq);
      const float p = ok ? expf(s * scale - lse_s[i]) : 0.f;
      axpy<kChunks>(dv_acc, operand(p, T()), dos[i], lane);
      const float ds = p * (dpv - delta_s[i]);
      axpy<kChunks>(dk_acc, operand(ds, T()), qs[i], lane);
    }
  }
  if (row_valid) {
    store_row<T, kChunks>(dk + krow * D, dk_acc, scale, lane);
    store_row<T, kChunks>(dv + krow * D, dv_acc, 1.f, lane);
  }
}

inline bool grid_of(int bh, int t, long long* blocks, int* n_tiles) {
  *n_tiles = (t + kRowsPerBlock - 1) / kRowsPerBlock;
  *blocks = (long long)bh * *n_tiles;
  return *blocks <= 0x7fffffffLL;
}

template <typename T, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, int bh, int tq,
                      int tk, float scale, int causal, cudaStream_t stream) {
  long long blocks;
  int n_qtiles;
  if (!grid_of(bh, tq, &blocks, &n_qtiles)) return cudaErrorInvalidValue;
  flash_bwd_dq_kernel<T, D><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), tq, tk,
      n_qtiles, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, void* dk, void* dv,
                       int bh, int tq, int tk, float scale, int causal,
                       cudaStream_t stream) {
  long long blocks;
  int n_ktiles;
  if (!grid_of(bh, tk, &blocks, &n_ktiles)) return cudaErrorInvalidValue;
  flash_bwd_dkv_kernel<T, D><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dk),
      static_cast<T*>(dv), tq, tk, n_ktiles, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_dq(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* delta, void* dq, int bh, int tq,
                        int tk, int d, float scale, int causal, cudaStream_t s) {
  switch (d) {
    case 16: return launch_dq<T, 16>(q, k, v, dout, lse, delta, dq, bh, tq, tk, scale, causal, s);
    case 32: return launch_dq<T, 32>(q, k, v, dout, lse, delta, dq, bh, tq, tk, scale, causal, s);
    case 64: return launch_dq<T, 64>(q, k, v, dout, lse, delta, dq, bh, tq, tk, scale, causal, s);
    case 128: return launch_dq<T, 128>(q, k, v, dout, lse, delta, dq, bh, tq, tk, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dkv(const void* q, const void* k, const void* v, const void* dout,
                         const float* lse, const float* delta, void* dk, void* dv,
                         int bh, int tq, int tk, int d, float scale, int causal,
                         cudaStream_t s) {
  switch (d) {
    case 16: return launch_dkv<T, 16>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, scale, causal, s);
    case 32: return launch_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, scale, causal, s);
    case 64: return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, scale, causal, s);
    case 128: return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, scale, causal, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. d must be 16, 32, 64 or 128 (the wrapper
// zero-pads other head dims up to the next of these). Each entry point returns
// cudaGetLastError() after its launch (0 = launched).
extern "C" int tac_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                void* dq, int bh, int tq, int tk, int d, int dtype,
                                int causal, float scale, void* stream) {
  if (bh < 1 || tq < 1 || tk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* de = static_cast<const float*>(delta);
  if (dtype == 0) return (int)dispatch_dq<float>(q, k, v, dout, l, de, dq, bh, tq, tk, d, scale, causal, s);
  if (dtype == 1) return (int)dispatch_dq<__nv_bfloat16>(q, k, v, dout, l, de, dq, bh, tq, tk, d, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int tac_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, int bh, int tq, int tk, int d,
                                 int dtype, int causal, float scale, void* stream) {
  if (bh < 1 || tq < 1 || tk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  const float* de = static_cast<const float*>(delta);
  if (dtype == 0) return (int)dispatch_dkv<float>(q, k, v, dout, l, de, dk, dv, bh, tq, tk, d, scale, causal, s);
  if (dtype == 1) return (int)dispatch_dkv<__nv_bfloat16>(q, k, v, dout, l, de, dk, dv, bh, tq, tk, d, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
