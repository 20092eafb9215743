// The payload GEMM of the `fused` backend and its dense twin, for Hopper
// (sm_90a):
//
//   zebra_spmm_cs_kernel <- spmm_cs.py::_spmm_cs_kernel     (payload operand)
//   zebra_spmm_kernel    <- zebra_spmm.py::_dense_gemm_kernel (dense operand)
//
// Both compute y (M, N) fp32 = sum over live (bs, bc) blocks of
// x_block @ w_panel, with the block keep map `bitmap` (nm, nk) int8. The
// dense kernel reads block (i, kc) from the row-major (M, K) map x; the
// payload kernel reads it from its consumer-order slot payload[slot[i*nk+kc]]
// of the (nb, bs, bc) stream. They are one device body, `gemm_block_rows`,
// templated on that block accessor and nothing else, so they are equal bit
// for bit (the counterpart of the Pallas `gemm_supertile_body`). Each is
// held against its plain PyTorch version (kernels/zebra_spmm.py,
// kernels/spmm_cs.py) to a tolerance: the plain version is one fp32 matmul,
// which sums in another order.
//
// The skip rule: a dead block is never read and contributes nothing; no
// product with its w panel is formed. So NaN/Inf in the w rows of a dead
// block does not reach the rows of that block (the plain version, which
// multiplies the zeroed block, gives NaN there). Bitwise 6 == 7 holds
// whatever w holds.
//
// Design (simple and correct first; tensor cores are later work): one CTA
// per (group of kWarps block rows, kTileN output columns); warp w of the CTA
// owns block row i = blockIdx.x * kWarps + w and keeps its bs x 4 outputs
// per lane in fp32 registers. The K-block columns are walked in ascending
// order; for each, a warp whose block is dead skips it, and when every block
// row of the CTA is dead the CTA skips the w panel too. A live block and the
// w panel are staged kChunk K elements at a time through shared memory (as
// float); every lane then does one fmaf per output per k, in ascending k.
// The sum of each output is therefore the same sequence of fmaf in both
// kernels, whatever the tile choice. Bounded by fp32 FMA issue on the CUDA
// cores: 2 * n_live * bs * bc * N operations (PERF.md has the tensor-core
// bound it is held against).
//
// Every entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError(). The wrappers count
// launches in zebra_spmm.zebra_spmm.launches and
// spmm_cs.zebra_spmm_cs.launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBs = 8;                 // block rows held in registers
constexpr int kWarps = 8;                 // block rows per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kTileN = 128;               // output columns per CTA, 4 per lane
constexpr int kChunk = 32;                // K elements staged per step

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Block (i, kc) of a dense row-major (M, K) map.
template <typename T>
struct DenseBlocks {
  const T* x;
  int64_t K;
  int bs, bc;
  __device__ const T* block(int64_t i, int64_t kc, int64_t) const {
    return x + i * bs * K + kc * bc;
  }
  __device__ int64_t row_stride() const { return K; }
};

// Block (i, kc) from its consumer-order payload slot; only called for live
// blocks, so a dead block's aliased slot is never read.
template <typename T>
struct PayloadBlocks {
  const T* payload;
  const int32_t* slot;
  int bs, bc;
  __device__ const T* block(int64_t i, int64_t kc, int64_t nk) const {
    return payload + (int64_t)slot[i * nk + kc] * bs * bc;
  }
  __device__ int64_t row_stride() const { return bc; }
};

// THE GEMM body of both kernels (see the header).
template <typename T, typename Blocks>
__device__ __forceinline__ void gemm_block_rows(
    const Blocks& blocks, const int8_t* __restrict__ bitmap,
    const T* __restrict__ w, float* __restrict__ y, int64_t nm, int64_t nk,
    int64_t N, int bs, int bc) {
  __shared__ __align__(16) float ws[kChunk][kTileN];
  __shared__ __align__(16) float xs[kWarps][kChunk][kMaxBs];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * kWarps + warp;
  const int64_t n0 = (int64_t)blockIdx.y * kTileN;
  const int64_t stride = blocks.row_stride();
  float acc[kMaxBs][4];
#pragma unroll
  for (int r = 0; r < kMaxBs; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  }
  for (int64_t kc = 0; kc < nk; ++kc) {
    const bool live = i < nm && bitmap[i * nk + kc] != 0;
    if (!__syncthreads_or(live)) continue;   // the CTA's blocks all dead
    const T* blk = live ? blocks.block(i, kc, nk) : nullptr;
    for (int k0 = 0; k0 < bc; k0 += kChunk) {
      const int len = min(kChunk, bc - k0);
      const T* wrow = w + (kc * bc + k0) * N;
      for (int e = threadIdx.x; e < kChunk * kTileN; e += kThreads) {
        const int kk = e / kTileN, c = e % kTileN;
        const int64_t n = n0 + c;
        ws[kk][c] = (kk < len && n < N) ? to_float(wrow[kk * N + n]) : 0.0f;
      }
      if (live) {
        for (int e = lane; e < kChunk * kMaxBs; e += 32) {
          const int r = e / kChunk, kk = e % kChunk;
          xs[warp][kk][r] =
              (r < bs && kk < len) ? to_float(blk[r * stride + k0 + kk]) : 0.0f;
        }
      }
      __syncthreads();
      if (live) {
        for (int kk = 0; kk < len; ++kk) {
          const float4 wv = *reinterpret_cast<const float4*>(&ws[kk][lane * 4]);
          const float4 a0 = *reinterpret_cast<const float4*>(&xs[warp][kk][0]);
          const float4 a1 = *reinterpret_cast<const float4*>(&xs[warp][kk][4]);
          const float a[kMaxBs] = {a0.x, a0.y, a0.z, a0.w,
                                   a1.x, a1.y, a1.z, a1.w};
#pragma unroll
          for (int r = 0; r < kMaxBs; ++r) {
            acc[r][0] = fmaf(a[r], wv.x, acc[r][0]);
            acc[r][1] = fmaf(a[r], wv.y, acc[r][1]);
            acc[r][2] = fmaf(a[r], wv.z, acc[r][2]);
            acc[r][3] = fmaf(a[r], wv.w, acc[r][3]);
          }
        }
      }
      __syncthreads();
    }
  }
  if (i >= nm) return;
#pragma unroll
  for (int r = 0; r < kMaxBs; ++r) {
    if (r >= bs) break;
    float* yrow = y + (i * bs + r) * N;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int64_t n = n0 + lane * 4 + c;
      if (n < N) yrow[n] = acc[r][c];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
zebra_spmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const int8_t* __restrict__ bitmap, float* __restrict__ y,
                  int64_t nm, int64_t nk, int64_t N, int bs, int bc) {
  const DenseBlocks<T> blocks{x, nk * bc, bs, bc};
  gemm_block_rows<T>(blocks, bitmap, w, y, nm, nk, N, bs, bc);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
zebra_spmm_cs_kernel(const T* __restrict__ payload,
                     const int32_t* __restrict__ slot, const T* __restrict__ w,
                     const int8_t* __restrict__ bitmap, float* __restrict__ y,
                     int64_t nm, int64_t nk, int64_t N, int bs, int bc) {
  const PayloadBlocks<T> blocks{payload, slot, bs, bc};
  gemm_block_rows<T>(blocks, bitmap, w, y, nm, nk, N, bs, bc);
}

dim3 grid_for(int64_t nm, int64_t N) {
  return dim3((unsigned)((nm + kWarps - 1) / kWarps),
              (unsigned)((N + kTileN - 1) / kTileN));
}

bool bad_shape(long long nm, long long nk, long long N, int bs, int bc) {
  return bs < 1 || bs > kMaxBs || bc < 1 || nm < 0 || nk < 0 || N < 0 ||
         (N + kTileN - 1) / kTileN > 65535;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and w alike). y is (M, N) float32.
int zebra_spmm_launch(const void* x, const void* w, const void* bitmap, void* y,
                      long long M, long long K, long long N, int bs, int bc,
                      int dtype, void* stream) {
  const long long nm = M / bs, nk = K / bc;
  if (bad_shape(nm, nk, N, bs, bc)) return (int)cudaErrorInvalidValue;
  if (nm == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* bm = static_cast<const int8_t*>(bitmap);
  float* out = static_cast<float*>(y);
  if (dtype == 0) {
    zebra_spmm_kernel<float><<<grid_for(nm, N), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bm, out, nm,
        nk, N, bs, bc);
  } else if (dtype == 1) {
    zebra_spmm_kernel<__nv_bfloat16><<<grid_for(nm, N), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), bm, out, nm, nk, N, bs, bc);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int zebra_spmm_cs_launch(const void* payload, const void* slot, const void* w,
                         const void* bitmap, void* y, long long nm,
                         long long nk, long long N, int bs, int bc, int dtype,
                         void* stream) {
  if (bad_shape(nm, nk, N, bs, bc)) return (int)cudaErrorInvalidValue;
  if (nm == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* bm = static_cast<const int8_t*>(bitmap);
  const int32_t* sl = static_cast<const int32_t*>(slot);
  float* out = static_cast<float*>(y);
  if (dtype == 0) {
    zebra_spmm_cs_kernel<float><<<grid_for(nm, N), kThreads, 0, s>>>(
        static_cast<const float*>(payload), sl, static_cast<const float*>(w), bm,
        out, nm, nk, N, bs, bc);
  } else if (dtype == 1) {
    zebra_spmm_cs_kernel<__nv_bfloat16><<<grid_for(nm, N), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(payload), sl,
        static_cast<const __nv_bfloat16*>(w), bm, out, nm, nk, N, bs, bc);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
