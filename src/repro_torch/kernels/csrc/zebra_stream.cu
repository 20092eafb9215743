// Zebra kernels for Hopper (sm_90a): the comparator, the pack pass and the
// expander of the `stream` site backend, and the one-pass masking kernel of
// the `pallas` backend.
//
// Each kernel replaces one Pallas TPU kernel of src/repro/kernels:
//   zebra_bitmap_kernel  <- mask_pack.py::_bitmap_kernel       (phase 1)
//   zebra_pack_kernel    <- mask_pack.py::_gather_pack_kernel  (phase 2b)
//   zebra_unpack_kernel  <- pack.py::_unpack_kernel
//   zebra_mask_kernel    <- zebra_mask.py::_zebra_mask_kernel
// and is held bit for bit against its plain PyTorch version
// (kernels/mask_pack.py, kernels/pack.py, kernels/zebra_mask.py).
//
// Layout: x is a row-major (M, K) map cut into (bs, bc) Zebra blocks, block
// g = r * nk + k at rows [r*bs, (r+1)*bs) and columns [k*bc, (k+1)*bc).
// The payload is (nb, bs, bc): slot s holds one block, row-major inside.
// bs and bc are runtime ints, so one build serves 8x8, 4x4 and 2x2 CNN
// blocks and 8x128 token blocks.
//
// Design: one warp per Zebra block, grid-stride over blocks. Lane l touches
// the block's elements l, l+32, ...; for bc = 8 a warp load covers four
// full 32-byte rows, so every DRAM sector fetched is used. All three
// kernels are bound by device-memory bytes, not by arithmetic:
//   comparator: the map read once + the int8 bitmap written;
//   pack:       the live blocks read + the bitmap and the live blocks' slot
//               entries read + the whole (nb, bs, bc) payload written, zero
//               tail included;
//   unpack:     the live payload blocks read + the bitmap and the live
//               blocks' slot entries read + the (M, K) map written;
//   mask:       the map read + the masked map and the int8 bitmap written.
// Blocks run in no order on the card, so the TPU pack kernel's "live write
// wins" ordering does not exist here: the pack kernel scatters each live
// block to its own slot (live slots are a bijection onto [0, n_live)) and
// zero-fills slots [n_live, nb), two disjoint sets of writes.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch. The wrappers count launches:
// mask_pack.zebra_bitmap.launches, mask_pack.pack_blocks.launches and
// pack.zebra_unpack.launches and zebra_mask.zebra_mask.launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int64_t kMaxGrid = 132 * 32;  // grid-stride beyond 32 blocks per SM

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Max that propagates NaN, like jnp.max and torch.amax (fmaxf drops NaN):
// a block holding NaN has a NaN max, compares false, and is dead.
__device__ __forceinline__ float nan_max(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return a > b ? a : b;
}

int grid_for(int64_t nb) {
  int64_t g = (nb + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return (int)(g < kMaxGrid ? g : kMaxGrid);
}

// Phase 1: keep[g] = max|x| over block g >= thr, thr already rounded to
// the map's dtype (every bf16 value is exact in float, so comparing in
// float is comparing in bf16).
// max|x| over the (bs, bc) block at src (row stride K), reduced across the
// warp: every lane returns the block's max.
template <typename T>
__device__ __forceinline__ float warp_block_absmax(const T* src, int64_t K,
                                                   int bs, int bc, int lane) {
  const int n = bs * bc;
  float m = 0.0f;  // |x| >= 0, so 0 is the identity (and fills idle lanes)
  for (int e = lane; e < n; e += 32) {
    m = nan_max(m, fabsf(to_float(src[(int64_t)(e / bc) * K + e % bc])));
  }
  for (int off = 16; off > 0; off >>= 1) {
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  return m;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
zebra_bitmap_kernel(const T* __restrict__ x, int8_t* __restrict__ bitmap,
                    int64_t nb, int64_t nk, int64_t K, int bs, int bc,
                    float thr) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t g = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       g < nb; g += stride) {
    const T* src = x + (g / nk) * bs * K + (g % nk) * bc;
    const float m = warp_block_absmax(src, K, bs, bc, lane);
    if (lane == 0) bitmap[g] = (m >= thr) ? 1 : 0;
  }
}

__device__ __forceinline__ float scale_by(float v, float k) { return v * k; }
__device__ __forceinline__ __nv_bfloat16 scale_by(__nv_bfloat16 v, float k) {
  return __float2bfloat16(__bfloat162float(v) * k);
}

// One pass of the `pallas` backend: keep[g] as the comparator computes it,
// then y = x * keep over the block. The product, not a select, as the
// Pallas kernel and the plain version compute it: a dead block of negative
// values gives -0.0, and one holding NaN or Inf gives NaN. The warp reads
// the block twice; the second read is of lines the first just fetched, which
// L1 or L2 usually still holds.
template <typename T>
__global__ void __launch_bounds__(kThreads)
zebra_mask_kernel(const T* __restrict__ x, T* __restrict__ y,
                  int8_t* __restrict__ bitmap, int64_t nb, int64_t nk,
                  int64_t K, int bs, int bc, float thr) {
  const int lane = threadIdx.x & 31;
  const int n = bs * bc;
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t g = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       g < nb; g += stride) {
    const int64_t base = (g / nk) * bs * K + (g % nk) * bc;
    const bool keep = warp_block_absmax(x + base, K, bs, bc, lane) >= thr;
    if (lane == 0) bitmap[g] = keep ? 1 : 0;
    const float k = keep ? 1.0f : 0.0f;
    for (int e = lane; e < n; e += 32) {
      const int64_t off = base + (int64_t)(e / bc) * K + e % bc;
      y[off] = scale_by(x[off], k);
    }
  }
}

// Phase 2b: payload[slot[g]] <- block g for every live g; payload[s] <- 0
// for s in [n_live, nb). U is an unsigned word of the element's size, so
// the copy moves bits (NaN payloads and -0.0 kept exactly).
template <typename U>
__global__ void __launch_bounds__(kThreads)
zebra_pack_kernel(const U* __restrict__ x, const int8_t* __restrict__ bitmap,
                  const int32_t* __restrict__ slot,
                  const int32_t* __restrict__ n_live_ptr,
                  U* __restrict__ payload, int64_t nb, int64_t nk, int64_t K,
                  int bs, int bc) {
  const int lane = threadIdx.x & 31;
  const int n = bs * bc;
  const int64_t n_live = *n_live_ptr;
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t g = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       g < nb; g += stride) {
    if (bitmap[g]) {
      const U* src = x + (g / nk) * bs * K + (g % nk) * bc;
      U* dst = payload + (int64_t)slot[g] * n;
      for (int e = lane; e < n; e += 32) {
        dst[e] = src[(int64_t)(e / bc) * K + e % bc];
      }
    }
    if (g >= n_live) {
      U* dst = payload + g * n;
      for (int e = lane; e < n; e += 32) dst[e] = U(0);
    }
  }
}

// Expander: out block g <- keep[g] ? payload[slot[g]] : +0. A dead block's
// slot aliases a live slot of its column; it is never read, and its zeros
// are written through a select, never by multiplying (which would leak
// NaN/Inf or -0.0 from the aliased block).
template <typename U>
__global__ void __launch_bounds__(kThreads)
zebra_unpack_kernel(const U* __restrict__ payload,
                    const int8_t* __restrict__ bitmap,
                    const int32_t* __restrict__ slot, U* __restrict__ out,
                    int64_t nb, int64_t nk, int64_t K, int bs, int bc) {
  const int lane = threadIdx.x & 31;
  const int n = bs * bc;
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t g = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       g < nb; g += stride) {
    U* dst = out + (g / nk) * bs * K + (g % nk) * bc;
    const bool live = bitmap[g] != 0;
    const U* src = payload + (live ? (int64_t)slot[g] * n : 0);
    for (int e = lane; e < n; e += 32) {
      dst[(int64_t)(e / bc) * K + e % bc] = live ? src[e] : U(0);
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.
int zebra_bitmap_launch(const void* x, void* bitmap, long long M, long long K,
                        int bs, int bc, float thr, int dtype, void* stream) {
  const int64_t nk = K / bc, nb = (M / bs) * nk;
  if (nb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    zebra_bitmap_kernel<float><<<grid_for(nb), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(bitmap), nb, nk, K,
        bs, bc, thr);
  } else if (dtype == 1) {
    zebra_bitmap_kernel<__nv_bfloat16><<<grid_for(nb), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(bitmap), nb,
        nk, K, bs, bc, thr);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int zebra_pack_launch(const void* x, const void* bitmap, const void* slot,
                      const void* n_live, void* payload, long long M,
                      long long K, int bs, int bc, int itemsize,
                      void* stream) {
  const int64_t nk = K / bc, nb = (M / bs) * nk;
  if (nb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* bm = static_cast<const int8_t*>(bitmap);
  const int32_t* sl = static_cast<const int32_t*>(slot);
  const int32_t* nl = static_cast<const int32_t*>(n_live);
  if (itemsize == 4) {
    zebra_pack_kernel<uint32_t><<<grid_for(nb), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(x), bm, sl, nl,
        static_cast<uint32_t*>(payload), nb, nk, K, bs, bc);
  } else if (itemsize == 2) {
    zebra_pack_kernel<uint16_t><<<grid_for(nb), kThreads, 0, s>>>(
        static_cast<const uint16_t*>(x), bm, sl, nl,
        static_cast<uint16_t*>(payload), nb, nk, K, bs, bc);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int zebra_unpack_launch(const void* payload, const void* bitmap,
                        const void* slot, void* out, long long M, long long K,
                        int bs, int bc, int itemsize, void* stream) {
  const int64_t nk = K / bc, nb = (M / bs) * nk;
  if (nb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* bm = static_cast<const int8_t*>(bitmap);
  const int32_t* sl = static_cast<const int32_t*>(slot);
  if (itemsize == 4) {
    zebra_unpack_kernel<uint32_t><<<grid_for(nb), kThreads, 0, s>>>(
        static_cast<const uint32_t*>(payload), bm, sl,
        static_cast<uint32_t*>(out), nb, nk, K, bs, bc);
  } else if (itemsize == 2) {
    zebra_unpack_kernel<uint16_t><<<grid_for(nb), kThreads, 0, s>>>(
        static_cast<const uint16_t*>(payload), bm, sl,
        static_cast<uint16_t*>(out), nb, nk, K, bs, bc);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16.
int zebra_mask_launch(const void* x, void* y, void* bitmap, long long M,
                      long long K, int bs, int bc, float thr, int dtype,
                      void* stream) {
  const int64_t nk = K / bc, nb = (M / bs) * nk;
  if (nb == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* bm = static_cast<int8_t*>(bitmap);
  if (dtype == 0) {
    zebra_mask_kernel<float><<<grid_for(nb), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y), bm, nb, nk, K,
        bs, bc, thr);
  } else if (dtype == 1) {
    zebra_mask_kernel<__nv_bfloat16><<<grid_for(nb), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        bm, nb, nk, K, bs, bc, thr);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
