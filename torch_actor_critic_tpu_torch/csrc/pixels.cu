// K1: fused replay-gather -> DrQ shift -> uint8 decode -> cast for Hopper
// (sm_90a), plain C interface for ctypes.
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
// One launch serves one or two frame leaves (a batch's states and next
// states) gathered at the same rows idx, each with its own ring, offsets and
// output: the leaf is blockIdx.y.
//
// Bound on an H100 SXM (3.35 TB/s): bytes. The least work is reading the
// B*S*H*W*C ring bytes once and writing the output once (4 bytes an element
// in f32, 2 in bf16): 18.9 MB at the wall-runner burst (B 512, 64x64x3, bf16),
// 5.6 us. There is no arithmetic to speak of, yet the first version of this
// kernel (one output element a thread) ran at 17% of that bound: per element
// it took two runtime integer divisions to find (y, x, c), an IEEE divide, two
// clamps, a one-byte load and a 2- or 4-byte store, so it was bound by
// instructions and a warp's store moved 64-128 bytes. At the training shape
// (B 64, 32x32x3) it is latency-bound instead: a block's chain is the idx
// load, then the ring load (random rows of a ring larger than L2), then its
// stores.
//
// This design:
// - A block owns one example b of one leaf and a tile of whole output rows,
//   all S stack slots of them: the tile is one contiguous run of output.
//   Tiles are sized so the grid has kBlocksPerSm blocks an SM where the batch
//   allows it (a small batch is latency-bound), and at most kMaxTileBytes.
// - Every thread reads idx[b] and the offsets itself and computes its ring
//   rows (floor-mod, the 64-bit division only out of range), so the ring
//   loads wait for no barrier. It stages the tile's source rows
//   ring[rows[b, s], sy] (W*C contiguous bytes each) in shared memory with
//   16-byte loads where the ring's alignment allows (4- or 1-byte loads where
//   not). The x-shift is then a clamped read from shared memory.
// - With /255, decode is a 256-entry table in shared memory that each block
//   builds once with the per-element arithmetic of the plain version.
// - Fast path (S = 1, C = 3, every frame the repo trains on, W a multiple of
//   the pixel group): a thread decodes a group of whole pixels, whose indices
//   are compile-time constants but for the clamped column, into a copy of the
//   tile in shared memory; then neighbouring threads store neighbouring
//   16-byte chunks of it. (Storing each thread's group straight to device
//   memory leaves a warp's 16-byte stores 48 bytes apart, each half-filling
//   a 32-byte sector, and was measured slower.)
// - General path (any S, C, alignment): a thread walks (r, x, s, c) with
//   counters, no per-element division, and stores 16 bytes at a time,
//   neighbouring threads neighbouring chunks; the few elements before the
//   first 16-byte boundary of the tile and after the last one are stored one
//   by one.
//
// Exactness: uint8 -> float and -> bf16 are exact; the normalize divide is the
// IEEE round-to-nearest divide (__fdiv_rn) in f32, rounded once to bf16 for a
// bf16 output, as torch computes v.to(dtype) / tensor(255, dtype). Ring
// offsets are 64-bit (row * H*W*C overflows 32 bits for a large ring), and the
// stack row uses floor-modulo (C's % is negative for idx < S-1).
//
// Layout: rings uint8 (capacity, H, W, C), idx int64 (B,), offsets int32
// (B, 2) or null (no shift), outputs (B, H, W, S*C) float or bf16; all
// contiguous. Grid: x = b * tiles + tile, y = leaf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
// Tiles: at least kBlocksPerSm blocks on each SM where the batch allows it,
// at most kMaxTileBytes of output a block.
constexpr int kBlocksPerSm = 4;
constexpr int kMaxTileBytes = 16384;
constexpr int kMaxSmem = 232448;  // an H100 block's shared-memory limit

template <typename T> struct Leaf {
  const uint8_t* ring;
  const int32_t* offsets;  // null: no shift
  T* out;
};

// An output element's bits: the kernel moves bits, T only sets the width.
template <typename T>
using Bits = typename std::conditional<sizeof(T) == 4, uint32_t, uint16_t>::type;

template <typename T, bool kNormalize>
__device__ __forceinline__ Bits<T> decode(unsigned v) {
  const float x = static_cast<float>(v);
  const float y = kNormalize ? __fdiv_rn(x, 255.0f) : x;
  if constexpr (sizeof(T) == 4) {
    return __float_as_uint(y);
  } else {
    // bf16(v) and bf16(255) are exact, so dividing them in f32 and rounding
    // once is the bf16 divide.
    return __bfloat16_as_ushort(__float2bfloat16_rn(y));
  }
}

// i floor-mod capacity; the 64-bit division only when i is out of range.
__device__ __forceinline__ long long ring_row(long long i, long long capacity) {
  if (i >= 0 && i < capacity) return i;
  const long long r = i % capacity;
  return r < 0 ? r + capacity : r;
}

__host__ __device__ constexpr int gcd(int a, int b) { return b == 0 ? a : gcd(b, a % b); }

// Copies the tile's rows * stack source rows (wc bytes each) into shared
// rows `stride` bytes apart, kWidth bytes a load: stage row r*stack + s holds
// ring[rows[b, s], sy(y0 + r)]. Thread tid takes loads tid, tid + kThreads,
// ...; (row, chunk) advance by fixed steps.
template <int kWidth>
__device__ __forceinline__ void stage_rows(uint8_t* stage, const uint8_t* ring,
                                           long long idx_b, long long capacity,
                                           int rows, int stack, int stride,
                                           int wc, int h, int y0, int dy) {
  using W = typename std::conditional<kWidth == 16, uint4,
            typename std::conditional<kWidth == 4, uint32_t, uint8_t>::type>::type;
  const int per_row = wc / kWidth;
  const long long frame = static_cast<long long>(h) * wc;
  int rs = threadIdx.x / per_row;
  int k = threadIdx.x - rs * per_row;
  const int step_rs = kThreads / per_row;
  const int step_k = kThreads - step_rs * per_row;
  for (; rs < rows * stack;) {
    const int r = stack == 1 ? rs : rs / stack;
    const int s = rs - r * stack;
    const int sy = min(max(y0 + r + dy, 0), h - 1);
    const uint8_t* src = ring + ring_row(idx_b - (stack - 1 - s), capacity) * frame +
                         static_cast<long long>(sy) * wc;
    reinterpret_cast<W*>(stage + rs * stride)[k] = reinterpret_cast<const W*>(src)[k];
    k += step_k;
    if (k >= per_row) {
      k -= per_row;
      ++rs;
    }
    rs += step_rs;
  }
}

// kFast: stack 1, C = kC, W a multiple of the pixel group below and a 16-byte
// aligned output; any other shape takes the general walk.
template <typename T, bool kNormalize, int kC, bool kFast>
__global__ void __launch_bounds__(kThreads)
pixel_gather_kernel(Leaf<T> leaf0, Leaf<T> leaf1, const int64_t* __restrict__ idx,
                    long long capacity, int h, int w, int c_runtime, int stack,
                    int pad, int tile_rows, int tiles, int stride) {
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte store
  const int C = kC ? kC : c_runtime;
  const Leaf<T> leaf = blockIdx.y ? leaf1 : leaf0;
  const long long b = blockIdx.x / tiles;
  const int y0 = static_cast<int>(blockIdx.x - b * tiles) * tile_rows;
  const int rows = min(tile_rows, h - y0);
  const int wc = w * C;
  const int tid = threadIdx.x;

  // Shared: the decode table, the staged rows, in the fast path the tile.
  extern __shared__ __align__(16) uint8_t smem[];
  Bits<T>* table = reinterpret_cast<Bits<T>*>(smem);
  uint8_t* stage = smem + 256 * sizeof(Bits<T>);

  // Every thread reads idx[b] and the offsets itself (one broadcast load),
  // so the ring loads wait for no barrier. Without offsets the shift is the
  // identity: sy = clip(y + pad - pad) = y.
  const long long idx_b = idx[b];
  int dy = 0, dx = 0;
  if (leaf.offsets != nullptr) {
    dy = leaf.offsets[2 * b] - pad;
    dx = leaf.offsets[2 * b + 1] - pad;
  }
  if constexpr (kNormalize) {
    for (int v = tid; v < 256; v += kThreads) table[v] = decode<T, true>(v);
  }
  // The ring's rows start on 16-byte boundaries when its base, a frame and a
  // row are multiples of 16 bytes.
  const unsigned align = static_cast<unsigned>(reinterpret_cast<uintptr_t>(leaf.ring)) |
                         static_cast<unsigned>(h * wc) | static_cast<unsigned>(wc);
  if ((align & 15) == 0) {
    stage_rows<16>(stage, leaf.ring, idx_b, capacity, rows, stack, stride, wc, h, y0, dy);
  } else if ((align & 3) == 0) {
    stage_rows<4>(stage, leaf.ring, idx_b, capacity, rows, stack, stride, wc, h, y0, dy);
  } else {
    stage_rows<1>(stage, leaf.ring, idx_b, capacity, rows, stack, stride, wc, h, y0, dy);
  }
  __syncthreads();

  auto lookup = [&](unsigned v) -> uint32_t {
    if constexpr (kNormalize) {
      return table[v];
    } else {
      return decode<T, false>(v);
    }
  };
  // The tile's output: rows * row_len contiguous elements, row_len = W*S*C.
  const int sc = stack * C;
  const int row_len = w * sc;
  Bits<T>* out = reinterpret_cast<Bits<T>*>(leaf.out) +
                 (b * h + y0) * static_cast<long long>(row_len);

  if constexpr (kFast) {
    // Thread i decodes kGroup whole pixels of one row (kGroup*kC elements, a
    // multiple of 16 bytes) into the tile's copy in shared memory, in
    // kWords / 4 16-byte stores; every index but the clamped source column
    // is known at compile time. Then neighbouring threads store neighbouring
    // 16-byte chunks of the tile to device memory.
    constexpr int kGroup = 16 / gcd(kC * static_cast<int>(sizeof(T)), 16);
    constexpr int kWords = kGroup * kC * static_cast<int>(sizeof(T)) / 4;
    Bits<T>* tile = reinterpret_cast<Bits<T>*>(stage + tile_rows * stack * stride);
    const int groups = w / kGroup;
    for (int i = tid; i < rows * groups; i += kThreads) {
      const int r = i / groups;
      const int x0 = (i - r * groups) * kGroup;
      const uint8_t* src = stage + r * stride;
      uint32_t words[kWords];
#pragma unroll
      for (int p = 0; p < kGroup; ++p) {
        const int sx = min(max(x0 + p + dx, 0), w - 1) * kC;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          const int e = p * kC + c;
          const uint32_t bits = lookup(src[sx + c]);
          if constexpr (sizeof(T) == 4) {
            words[e] = bits;
          } else if (e & 1) {
            words[e / 2] |= bits << 16;
          } else {
            words[e / 2] = bits;
          }
        }
      }
      uint4* dst = reinterpret_cast<uint4*>(tile + (r * w + x0) * kC);
#pragma unroll
      for (int q = 0; q < kWords / 4; ++q) {
        dst[q] = make_uint4(words[4 * q], words[4 * q + 1], words[4 * q + 2], words[4 * q + 3]);
      }
    }
    __syncthreads();
    const int chunks = rows * row_len / V;
    for (int k = tid; k < chunks; k += kThreads) {
      reinterpret_cast<uint4*>(out)[k] = reinterpret_cast<const uint4*>(tile)[k];
    }
    return;
  }

  // The general walk, for any stack, C and alignment.
  const int n = rows * row_len;
  const int misalign = static_cast<int>((reinterpret_cast<uintptr_t>(out) / sizeof(T)) % V);
  const int head = min(n, (V - misalign) % V);
  const int nvec = (n - head) / V;
  const int tail = head + nvec * V;

  // Shared-memory offset of the byte that output element (r, x, s, c) reads.
  auto src = [&](int r, int x, int s, int c) {
    const int sx = min(max(x + dx, 0), w - 1);
    return (r * stack + s) * stride + sx * C + c;
  };

  // The ragged ends (fewer than V elements each), one element a thread.
  {
    int e = -1;
    if (tid < head) e = tid;
    else if (tid - head < n - tail) e = tail + (tid - head);
    if (e >= 0) {
      const int r = e / row_len;
      const int q = e - r * row_len;
      const int x = q / sc;
      const int k = q - x * sc;
      out[e] = lookup(stage[src(r, x, k / C, k % C)]);
    }
  }

  // The body: thread tid stores chunks tid, tid + kThreads, ... Its first
  // chunk's (r, x, s, c) takes divisions once; each next one is a fixed
  // step of kThreads*V elements, split the same way.
  int j = tid;
  if (j >= nvec) return;
  int r, x, s, c;
  {
    const int e = head + j * V;
    r = e / row_len;
    const int q = e - r * row_len;
    x = q / sc;
    const int k = q - x * sc;
    s = k / C;
    c = k - s * C;
  }
  constexpr int kStep = kThreads * V;
  const int step_r = kStep / row_len;
  const int step_q = kStep - step_r * row_len;
  const int step_x = step_q / sc;
  const int step_k = step_q - step_x * sc;
  const int step_s = step_k / C;
  const int step_c = step_k - step_s * C;

  for (;;) {
    uint32_t words[4];
    int xr = x, sr = s, cr = c, rr = r;
    int a = src(rr, xr, sr, cr);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const uint32_t bits = lookup(stage[a]);
      if constexpr (V == 4) {
        words[i] = bits;
      } else if (i & 1) {
        words[i / 2] |= bits << 16;
      } else {
        words[i / 2] = bits;
      }
      if (i + 1 < V) {  // step to the next element: c, then s, then x, then r
        ++cr;
        ++a;
        if (cr == C) {
          cr = 0;
          a += stride - C;
          if (++sr == stack) {
            sr = 0;
            if (++xr == w) {
              xr = 0;
              ++rr;
            }
            a = src(rr, xr, 0, 0);
          }
        }
      }
    }
    *reinterpret_cast<uint4*>(out + head + j * V) =
        make_uint4(words[0], words[1], words[2], words[3]);

    j += kThreads;
    if (j >= nvec) break;
    c += step_c;
    if (c >= C) {
      c -= C;
      ++s;
    }
    s += step_s;
    if (s >= stack) {
      s -= stack;
      ++x;
    }
    x += step_x;
    if (x >= w) {
      x -= w;
      ++r;
    }
    r += step_r;
  }
}

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    count[dev] = 132;
  return count[dev];
}

template <typename T, bool kNormalize, int kC, bool kFast>
cudaError_t launch(const Leaf<T>& l0, const Leaf<T>& l1, int leaves,
                   const int64_t* idx, long long capacity, int h, int w, int c,
                   int b, int stack, int pad, cudaStream_t stream) {
  // Tiles of whole rows: enough of them for kBlocksPerSm blocks an SM (a
  // small batch is latency-bound, and more blocks shorten each one's chain),
  // none above kMaxTileBytes of output, balanced over H.
  const long long out_row = static_cast<long long>(w) * stack * c * sizeof(T);
  long long tiles = (static_cast<long long>(kBlocksPerSm) * sm_count() + b * leaves - 1) /
                    (static_cast<long long>(b) * leaves);
  tiles = std::max(tiles, (h * out_row + kMaxTileBytes - 1) / kMaxTileBytes);
  tiles = std::min<long long>(std::max(tiles, 1LL), h);
  const int tile_rows = static_cast<int>((h + tiles - 1) / tiles);
  tiles = (h + tile_rows - 1) / tile_rows;
  const int stride = (w * c + 15) & ~15;
  // Shared: the table, the staged rows, and in the fast path the decoded tile.
  const long long smem = 256 * static_cast<long long>(sizeof(Bits<T>)) +
                         static_cast<long long>(tile_rows) * stack * stride +
                         (kFast ? tile_rows * out_row : 0);
  if (smem > kMaxSmem || b * tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = pixel_gather_kernel<T, kNormalize, kC, kFast>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  dim3 grid(static_cast<unsigned>(b * tiles), static_cast<unsigned>(leaves));
  kernel<<<grid, kThreads, static_cast<size_t>(smem), stream>>>(
      l0, l1, idx, capacity, h, w, c, stack, pad, tile_rows, static_cast<int>(tiles), stride);
  return cudaGetLastError();
}

template <typename T, bool kNormalize>
cudaError_t dispatch_shape(const Leaf<T>& l0, const Leaf<T>& l1, int leaves,
                           const int64_t* idx, long long capacity, int h, int w,
                           int c, int b, int stack, int pad, cudaStream_t s) {
  if (c != 3)
    return launch<T, kNormalize, 0, false>(l0, l1, leaves, idx, capacity, h, w, c, b, stack, pad, s);
  constexpr int kGroup = 16 / gcd(3 * static_cast<int>(sizeof(T)), 16);
  // The fast path also holds a decoded row in shared memory: a one-row tile
  // must fit (larger tiles are capped at kMaxTileBytes).
  const long long one_row = 256 * static_cast<long long>(sizeof(Bits<T>)) +
                            ((3LL * w + 15) & ~15LL) + 3LL * w * sizeof(T);
  bool fast = stack == 1 && w % kGroup == 0 && one_row <= kMaxSmem;
  for (int i = 0; i < leaves; ++i)
    fast = fast && reinterpret_cast<uintptr_t>(i ? l1.out : l0.out) % 16 == 0;
  return fast
      ? launch<T, kNormalize, 3, true>(l0, l1, leaves, idx, capacity, h, w, c, b, stack, pad, s)
      : launch<T, kNormalize, 3, false>(l0, l1, leaves, idx, capacity, h, w, c, b, stack, pad, s);
}

template <typename T>
cudaError_t dispatch(const void* ring0, const void* ring1, const void* idx,
                     const void* off0, const void* off1, void* out0, void* out1,
                     int leaves, long long capacity, int h, int w, int c, int b,
                     int stack, int pad, int normalize, cudaStream_t s) {
  const Leaf<T> l0{static_cast<const uint8_t*>(ring0),
                   static_cast<const int32_t*>(off0), static_cast<T*>(out0)};
  const Leaf<T> l1 = leaves == 2
      ? Leaf<T>{static_cast<const uint8_t*>(ring1), static_cast<const int32_t*>(off1),
                static_cast<T*>(out1)}
      : l0;
  const int64_t* ix = static_cast<const int64_t*>(idx);
  return normalize
      ? dispatch_shape<T, true>(l0, l1, leaves, ix, capacity, h, w, c, b, stack, pad, s)
      : dispatch_shape<T, false>(l0, l1, leaves, ix, capacity, h, w, c, b, stack, pad, s);
}

}  // namespace

// One or two leaves (leaves = 1 or 2) gathered at the same rows idx: leaf i
// reads ring_i with offsets off_i (null: no shift) and writes out_i; the
// second leaf's pointers are ignored when leaves = 1. dtype: 0 = float32,
// 1 = bfloat16 output. Returns cudaGetLastError() after the launch
// (0 = launched), or cudaErrorInvalidValue for arguments it does not take.
extern "C" int tac_pixel_gather(const void* ring0, const void* ring1,
                                const void* idx, const void* off0,
                                const void* off1, void* out0, void* out1,
                                int leaves, long long capacity, int h, int w,
                                int c, int b, int stack, int pad, int dtype,
                                int normalize, void* stream) {
  if (capacity < 1 || h < 1 || w < 1 || c < 1 || b < 1 || stack < 1 ||
      (leaves != 1 && leaves != 2) || ring0 == nullptr || out0 == nullptr ||
      (leaves == 2 && (ring1 == nullptr || out1 == nullptr)))
    return (int)cudaErrorInvalidValue;
  // A frame's, and a tile's output, element indices are 32-bit.
  if (static_cast<long long>(h) * w * c * stack > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(ring0, ring1, idx, off0, off1, out0, out1, leaves,
                          capacity, h, w, c, b, stack, pad, normalize, s);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(ring0, ring1, idx, off0, off1, out0, out1,
                                  leaves, capacity, h, w, c, b, stack, pad,
                                  normalize, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
