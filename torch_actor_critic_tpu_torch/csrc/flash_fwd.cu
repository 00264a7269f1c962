// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the TPU kernel torch_actor_critic_tpu/ops/attention.py::_flash_kernel
// (launched by _flash_forward through pl.pallas_call). Same function: online-
// softmax attention over (batch*heads, T, d), optional causal mask, f32 running
// max / normaliser / accumulator, keys past the diagonal skipped, optional f32
// per-row logsumexp for a backward pass. For bf16 inputs the probability tile is
// rounded to bf16 before P.V, as the TPU kernel's _acc_dot does; the normaliser
// sums the unrounded f32 probabilities.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 tensor, 67 TFLOP/s f32, 3.35 TB/s):
//  - serving shape (64, 4, 16, 16) causal: ~2 MFLOP and ~1 MB per call, i.e.
//    well under a microsecond of either resource -> launch-bound (a few us of
//    launch overhead dominates). The design keeps it to ONE launch per layer,
//    one block per (batch*head, 32-row q tile), with no host-side padding or
//    extra passes for d = 16/32/64/128.
//  - bench shape (4, 8, 2048, 64) causal: ~17 GFLOP, operations-bound. This first
//    version runs the two products on the f32 CUDA cores (not the tensor cores),
//    so its floor is the 67 TFLOP/s f32 rate; wgmma/TMA/warp specialisation are
//    later work. What it does about the bound: K/V tiles are staged once per
//    block in shared memory and read as float4 (4 FMAs per shared load, with
//    the 8 rows of a warp sharing each address), and k tiles wholly past the
//    diagonal are never loaded.
//
// Layout: q, o are (BH, Tq, D); k, v are (BH, Tk, D); all contiguous, one dtype.
// lse (optional) is (BH, Tq) f32. Any Tq/Tk >= 1: the ragged tail is masked.
// Thread layout: 4 threads per query row, each owning D/4 head dims as float4
// chunks (dims c*16 + lane*4 .. +3); a row's partial dot products are summed
// with two xor-shuffles inside its 4-lane group.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 32;            // BQ
constexpr int kLanesPerRow = 4;              // threads sharing one query row
constexpr int kThreads = kRowsPerBlock * kLanesPerRow;

template <int D> struct TileK { static constexpr int value = D <= 64 ? 64 : 32; };

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

// The probability as the P.V product sees it: unchanged for f32 inputs,
// rounded to bf16 for bf16 inputs.
__device__ __forceinline__ float pv_operand(float p, float) { return p; }
__device__ __forceinline__ float pv_operand(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int tq, int tk, int n_qtiles,
                 float scale, int causal) {
  constexpr int BK = TileK<D>::value;
  constexpr int kChunks = D / (4 * kLanesPerRow);  // float4 chunks per thread
  __shared__ __align__(16) float ks[BK][D];
  __shared__ __align__(16) float vs[BK][D];

  const int bh = blockIdx.x / n_qtiles;
  const int qt = blockIdx.x % n_qtiles;
  const int tid = threadIdx.x;
  const int row = tid / kLanesPerRow;
  const int lane = tid % kLanesPerRow;
  const int qi = qt * kRowsPerBlock + row;
  const bool row_valid = qi < tq;

  const T* qb = q + (size_t)bh * tq * D;
  const T* kb = k + (size_t)bh * tk * D;
  const T* vb = v + (size_t)bh * tk * D;

  float qr[kChunks * 4];
  float acc[kChunks * 4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    float4 x = row_valid ? load4(qb + (size_t)qi * D + c * 16 + lane * 4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[c * 4 + 0] = x.x; qr[c * 4 + 1] = x.y;
    qr[c * 4 + 2] = x.z; qr[c * 4 + 3] = x.w;
    acc[c * 4 + 0] = 0.f; acc[c * 4 + 1] = 0.f;
    acc[c * 4 + 2] = 0.f; acc[c * 4 + 3] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  // Causal: the last row of this tile sees keys up to its own index, so
  // tiles starting past it are skipped entirely (never loaded).
  const int q_last = min((qt + 1) * kRowsPerBlock, tq) - 1;
  const int k_stop = causal ? min(tk, q_last + 1) : tk;

  for (int k0 = 0; k0 < k_stop; k0 += BK) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = tid; idx < BK * D / 4; idx += kThreads) {
      const int r = idx / (D / 4);
      const int col = (idx % (D / 4)) * 4;
      const int kk = k0 + r;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (kk < tk) {
        kx = load4(kb + (size_t)kk * D + col);
        vx = load4(vb + (size_t)kk * D + col);
      }
      store4(&ks[r][col], kx);
      store4(&vs[r][col], vx);
    }
    __syncthreads();

    float s[BK];
    float m_tile = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kx = *reinterpret_cast<const float4*>(&ks[j][c * 16 + lane * 4]);
        part = fmaf(qr[c * 4 + 0], kx.x, part);
        part = fmaf(qr[c * 4 + 1], kx.y, part);
        part = fmaf(qr[c * 4 + 2], kx.z, part);
        part = fmaf(qr[c * 4 + 3], kx.w, part);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kk = k0 + j;
      const bool ok = kk < tk && (!causal || kk <= qi);
      s[j] = ok ? part * scale : -INFINITY;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    // A row that has seen no key yet keeps m_new == -inf; exp(-inf - 0) = 0
    // then leaves its state untouched instead of producing NaN.
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = expf(m - m_use);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kChunks * 4; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_use);
      l += p;
      const float pv = pv_operand(p, T());
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 vx = *reinterpret_cast<const float4*>(&vs[j][c * 16 + lane * 4]);
        acc[c * 4 + 0] = fmaf(pv, vx.x, acc[c * 4 + 0]);
        acc[c * 4 + 1] = fmaf(pv, vx.y, acc[c * 4 + 1]);
        acc[c * 4 + 2] = fmaf(pv, vx.z, acc[c * 4 + 2]);
        acc[c * 4 + 3] = fmaf(pv, vx.w, acc[c * 4 + 3]);
      }
    }
    m = m_new;
  }

  if (!row_valid) return;
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  T* ob = o + (size_t)bh * tq * D + (size_t)qi * D;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    store4(ob + c * 16 + lane * 4,
           make_float4(acc[c * 4 + 0] * inv, acc[c * 4 + 1] * inv,
                       acc[c * 4 + 2] * inv, acc[c * 4 + 3] * inv));
  }
  if (lse != nullptr && lane == 0) {
    lse[(size_t)bh * tq + qi] = l == 0.f ? -INFINITY : m + logf(l);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int tq, int tk, float scale, int causal,
                   cudaStream_t stream) {
  const int n_qtiles = (tq + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long blocks = (long long)bh * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_fwd_kernel<T, D><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      tq, tk, n_qtiles, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int tq, int tk, int d, float scale,
                       int causal, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, lse, bh, tq, tk, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, lse, bh, tq, tk, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, lse, bh, tq, tk, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, lse, bh, tq, tk, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. d must be 16, 32, 64 or 128 (the wrapper
// zero-pads other head dims up to the next of these). lse may be null.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int tac_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int bh, int tq, int tk, int d,
                             int dtype, int causal, float scale, void* stream) {
  if (bh < 1 || tq < 1 || tk < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_d<float>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, s);
  } else if (dtype == 1) {
    err = dispatch_d<__nv_bfloat16>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
