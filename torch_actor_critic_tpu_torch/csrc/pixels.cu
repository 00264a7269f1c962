// Fused replay-gather -> DrQ shift -> uint8 decode -> cast for Hopper (sm_90a),
// plain C interface for ctypes.
//
// Replaces the TPU kernel torch_actor_critic_tpu/ops/pixels.py::_pixel_kernel
// (launched by _gather_frames_pallas through pl.pallas_call). Same function:
// for example b, stack slot s, row y, column x, channel c
//
//   out[b, y, x, s*C + c] = decode(ring[rows[b, s], sy, sx, c])
//   rows[b, s] = (idx[b] - (S-1-s)) floor-mod capacity
//   sy = clip(y + off[b, 0] - pad, 0, H-1), sx likewise with off[b, 1]
//   decode(v) = (out type) v, then / 255 when normalize
//
// The TPU kernel expresses the shift as two one-hot matmuls, the form its
// matrix unit runs well. Here it is a direct gather: each output element
// computes its clipped source index and reads one byte.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. There is no arithmetic to speak of;
// the least work is reading B*S*H*W*C ring bytes once and writing the output
// once (4 bytes an element in f32, 2 in bf16), e.g. ~1 MB at the training shape
// (B 64, 32x32x3, f32), i.e. ~0.3 us, far below a launch. What the design does
// about it: one pass, no intermediate in device memory (the uint8 frames are
// never staged, shifted or decoded into a temporary), neighbouring threads
// write neighbouring output addresses (threads walk (y, x, c) in row-major
// order), and each block computes its own ring row from idx (no prefetch pass).
// Not yet done (later work): 16-byte vector loads and stores, and fusing the
// gather into the first convolution's input.
//
// Exactness: uint8 -> float and -> bf16 are exact; the normalize divide is the
// IEEE round-to-nearest divide (__fdiv_rn) in f32, rounded once to bf16 for a
// bf16 output, as torch computes v.to(dtype) / tensor(255, dtype). Ring
// offsets are 64-bit (row * H*W*C overflows 32 bits for a large ring), and the
// stack row uses floor-modulo (C's % is negative for idx < S-1).
//
// Layout: ring uint8 (capacity, H, W, C), idx int64 (B,), offsets int32 (B, 2)
// or null (no shift), out (B, H, W, S*C) float or bf16; all contiguous.
// Grid: x = b*S + s, y = tiles of kRowsPerTile output rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerTile = 8;

template <typename T, bool kNormalize> struct Decode;

template <bool kNormalize> struct Decode<float, kNormalize> {
  __device__ __forceinline__ static float apply(uint8_t v) {
    float x = static_cast<float>(v);
    return kNormalize ? __fdiv_rn(x, 255.0f) : x;
  }
};

template <bool kNormalize> struct Decode<__nv_bfloat16, kNormalize> {
  __device__ __forceinline__ static __nv_bfloat16 apply(uint8_t v) {
    // bf16(v) and bf16(255) are exact, so dividing them in f32 and rounding
    // once is the bf16 divide.
    float x = static_cast<float>(v);
    return __float2bfloat16_rn(kNormalize ? __fdiv_rn(x, 255.0f) : x);
  }
};

template <typename T, bool kNormalize>
__global__ void __launch_bounds__(kThreads)
pixel_gather_kernel(const uint8_t* __restrict__ ring,
                    const int64_t* __restrict__ idx,
                    const int32_t* __restrict__ offsets, T* __restrict__ out,
                    long long capacity, int h, int w, int c, int stack, int pad) {
  const int slot = blockIdx.x % stack;
  const long long b = blockIdx.x / stack;
  long long row = (idx[b] - static_cast<long long>(stack - 1 - slot)) % capacity;
  if (row < 0) row += capacity;
  // Without offsets the shift is the identity: sy = clip(y + pad - pad) = y.
  int oy = pad, ox = pad;
  if (offsets != nullptr) {
    oy = offsets[2 * b];
    ox = offsets[2 * b + 1];
  }
  const int wc = w * c;
  const int out_c = stack * c;
  const uint8_t* src = ring + row * (static_cast<long long>(h) * wc);
  T* dst = out + b * (static_cast<long long>(h) * w * out_c) + slot * c;
  const int y0 = blockIdx.y * kRowsPerTile;
  const int rows = min(kRowsPerTile, h - y0);
  for (int e = threadIdx.x; e < rows * wc; e += kThreads) {
    const int y = y0 + e / wc;
    const int rem = e - (y - y0) * wc;
    const int x = rem / c;
    const int ch = rem - x * c;
    const int sy = min(max(y + oy - pad, 0), h - 1);
    const int sx = min(max(x + ox - pad, 0), w - 1);
    const uint8_t v = src[(sy * w + sx) * c + ch];
    dst[static_cast<long long>(y * w + x) * out_c + ch] = Decode<T, kNormalize>::apply(v);
  }
}

template <typename T, bool kNormalize>
cudaError_t launch(const void* ring, const void* idx, const void* offsets,
                   void* out, long long capacity, int h, int w, int c, int b,
                   int stack, int pad, cudaStream_t stream) {
  dim3 grid(static_cast<unsigned>(static_cast<long long>(b) * stack),
            static_cast<unsigned>((h + kRowsPerTile - 1) / kRowsPerTile));
  pixel_gather_kernel<T, kNormalize><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(ring), static_cast<const int64_t*>(idx),
      static_cast<const int32_t*>(offsets), static_cast<T*>(out), capacity, h,
      w, c, stack, pad);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_normalize(const void* ring, const void* idx,
                               const void* offsets, void* out,
                               long long capacity, int h, int w, int c, int b,
                               int stack, int pad, int normalize,
                               cudaStream_t stream) {
  return normalize
             ? launch<T, true>(ring, idx, offsets, out, capacity, h, w, c, b, stack, pad, stream)
             : launch<T, false>(ring, idx, offsets, out, capacity, h, w, c, b, stack, pad, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 output. offsets may be null (no shift).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int tac_pixel_gather(const void* ring, const void* idx,
                                const void* offsets, void* out,
                                long long capacity, int h, int w, int c, int b,
                                int stack, int pad, int dtype, int normalize,
                                void* stream) {
  if (capacity < 1 || h < 1 || w < 1 || c < 1 || b < 1 || stack < 1)
    return (int)cudaErrorInvalidValue;
  // Per-frame and per-output-row indices are 32-bit; the grid's x is < 2^31.
  if (static_cast<long long>(h) * w * c * stack > 0x7fffffffLL ||
      static_cast<long long>(b) * stack > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_normalize<float>(ring, idx, offsets, out, capacity, h, w, c,
                                    b, stack, pad, normalize, s);
  } else if (dtype == 1) {
    err = dispatch_normalize<__nv_bfloat16>(ring, idx, offsets, out, capacity,
                                            h, w, c, b, stack, pad, normalize, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
