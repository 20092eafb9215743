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
// blocks and 8x128 token blocks. The comparator and the masking kernel
// take float32, bfloat16 and float16; pack and unpack move 2- or 4-byte
// words whatever they hold.
//
// All four kernels are bound by device-memory bytes, not by arithmetic:
//   comparator: the map read once + the int8 bitmap written;
//   pack:       the live blocks read + the bitmap and the live blocks' slot
//               entries read + the whole (nb, bs, bc) payload written, zero
//               tail included;
//   unpack:     the live payload blocks read + the bitmap and the live
//               blocks' slot entries read + the (M, K) map written;
//   mask:       the map read + the masked map and the int8 bitmap written.
//
// The comparator and the masking kernel are strip-mapped streaming kernels
// (strip_pass below): a lane owns one vector column of one block-row strip
// and loads it from every row of the block (or every R-th row of a narrow
// map) before it reduces, so up to 8 wide loads are in flight per lane, and
// the masking kernel writes y from the registers it reduced. Pack and unpack run one warp per Zebra block,
// grid-stride over blocks: lane l touches the block's elements l, l+32, ...
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
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int64_t kMaxGrid = 132 * 32;  // grid-stride beyond 32 blocks per SM

int grid_for(int64_t nb) {
  int64_t g = (nb + kWarpsPerBlock - 1) / kWarpsPerBlock;
  return (int)(g < kMaxGrid ? g : kMaxGrid);
}

// ---------------------------------------------------------------------------
// The comparator and the masking kernel
// ---------------------------------------------------------------------------
//
// A block row of bc elements is VB-byte vectors: VB = 16, 8, 4 or 2, the
// widest that divides bc*item, K*item and the data pointers (vec_bytes), so
// no vector straddles two blocks. A block's L = bc*item/VB vector columns
// go to Lc lanes, Lc = L rounded up to a power of two and capped at 32
// (lanes c >= L idle when L is not a power of two); lane c owns columns c,
// c+Lc, ... . Groups of G = Lc lanes sit on consecutive blocks of a block
// row, so a warp load reads whole 32-byte sectors, 512 B at VB 16. A lane
// loads its column of up to kRows rows before it reduces. A map row
// narrower than a 128-byte line (the CNN's late maps: 32 or 64 bytes) would
// leave each warp load a scatter of part-lines, so there R = 2, 4 or 8
// lanes split a block's rows (lane (c, h) loads rows h, h+R, ...), G = Lc*R,
// and a warp load covers R whole rows of each of its strips: whole lines.
// Indices: one 32-bit divide per thread at its start, then the (block row,
// block column) pair steps by constants over the grid-stride loop; no
// division per element or per block.
//
// max|x| as ordered unsigned bits: with the sign bit cleared, the bits of
// every non-NaN value order as its magnitude, and every NaN lies above
// +Inf. So the unsigned max of these bits is the block's max|x|, or a NaN
// when the block holds one, as jnp.max and torch.amax give it: a NaN block
// compares false and is dead. Max is exact in any order, so the bitmap does
// not depend on the tiling. 16-bit types reduce two halves per instruction
// (__vmaxu2).

constexpr int kRows = 8;      // block rows a lane holds in registers at once
constexpr unsigned kFull = 0xffffffffu;

template <int VB>
struct Vec {                  // the bits of one vector; VB 2: the low half of w[0]
  static constexpr int W = VB >= 4 ? VB / 4 : 1;
  uint32_t w[W];
};

template <int VB>
__device__ __forceinline__ Vec<VB> load_vec(const void* p) {
  Vec<VB> v;
  if constexpr (VB == 16) {
    const uint4 t = __ldg(static_cast<const uint4*>(p));
    v.w[0] = t.x; v.w[1] = t.y; v.w[2] = t.z; v.w[3] = t.w;
  } else if constexpr (VB == 8) {
    const uint2 t = __ldg(static_cast<const uint2*>(p));
    v.w[0] = t.x; v.w[1] = t.y;
  } else if constexpr (VB == 4) {
    v.w[0] = __ldg(static_cast<const unsigned int*>(p));
  } else {
    v.w[0] = __ldg(static_cast<const unsigned short*>(p));
  }
  return v;
}

template <int VB>
__device__ __forceinline__ void store_vec(void* p, const Vec<VB>& v) {
  if constexpr (VB == 16) {
    *static_cast<uint4*>(p) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  } else if constexpr (VB == 8) {
    *static_cast<uint2*>(p) = make_uint2(v.w[0], v.w[1]);
  } else if constexpr (VB == 4) {
    *static_cast<uint32_t*>(p) = v.w[0];
  } else {
    *static_cast<uint16_t*>(p) = (uint16_t)v.w[0];
  }
}

// Per element type: the |x|-bits max of a 32-bit word into an accumulator,
// the accumulator's final max, its value as a float (every bf16 and f16
// value is exact in float, so comparing in float is comparing in the map's
// dtype), and x * k of each element of a word, rounded back (exact: k is 0
// or 1).
template <typename T> struct Elem;

template <> struct Elem<float> {
  static __device__ __forceinline__ uint32_t absmax(uint32_t m, uint32_t w) {
    return max(m, w & 0x7fffffffu);
  }
  static __device__ __forceinline__ uint32_t fold(uint32_t m) { return m; }
  static __device__ __forceinline__ float value(uint32_t m) { return __uint_as_float(m); }
  static __device__ __forceinline__ uint32_t scale(uint32_t w, float k) {
    return __float_as_uint(__uint_as_float(w) * k);
  }
};

struct Elem16 {               // two 16-bit elements per word
  static __device__ __forceinline__ uint32_t absmax(uint32_t m, uint32_t w) {
    return __vmaxu2(m, w & 0x7fff7fffu);
  }
  static __device__ __forceinline__ uint32_t fold(uint32_t m) {
    return max(m & 0xffffu, m >> 16);
  }
};

template <> struct Elem<__nv_bfloat16> : Elem16 {
  static __device__ __forceinline__ float value(uint32_t m) { return __uint_as_float(m << 16); }
  static __device__ __forceinline__ uint32_t scale(uint32_t w, float k) {
    const float lo = __uint_as_float(w << 16) * k;
    const float hi = __uint_as_float(w & 0xffff0000u) * k;
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
};

template <> struct Elem<__half> : Elem16 {
  static __device__ __forceinline__ float value(uint32_t m) {
    return __half2float(__ushort_as_half((unsigned short)m));
  }
  static __device__ __forceinline__ uint32_t scale(uint32_t w, float k) {
    const float lo = __half2float(__ushort_as_half((unsigned short)(w & 0xffffu))) * k;
    const float hi = __half2float(__ushort_as_half((unsigned short)(w >> 16))) * k;
    return (uint32_t)__half_as_ushort(__float2half_rn(lo)) |
           ((uint32_t)__half_as_ushort(__float2half_rn(hi)) << 16);
  }
};

template <typename T, int VB>
__device__ __forceinline__ Vec<VB> scale_vec(Vec<VB> v, float k) {
#pragma unroll
  for (int i = 0; i < Vec<VB>::W; ++i) v.w[i] = Elem<T>::scale(v.w[i], k);
  return v;
}

// The shape of one launch, from the host (strip_geometry).
struct Strip {
  int64_t nb;                 // blocks
  int64_t K;                  // map row length, elements
  int nk, bs, bc;             // block columns; block shape
  int L;                      // vector columns per block row
  int lgc;                    // log2 Lc, the lanes per block row
  int lgr;                    // log2 R, the lanes that split a block's rows
  int lg;                     // log2 G = lgc + lgr, the lanes per block
  int P;                      // column passes per lane: ceil(L / Lc)
  float thr;                  // T_obj in the map's dtype
};

// The comparator (kMask false) and the masking kernel (kMask true). The
// group's lanes reduce with lg xor-shuffles, inside their aligned group of
// G lanes, never across a block boundary. Lane 0 of the group writes the
// bitmap byte. The masking kernel writes y = x * keep, the product and not
// a select (as the Pallas kernel and the plain version compute it: a dead
// block of negative values gives -0.0, one holding NaN or Inf gives NaN),
// from the vectors the lane already holds; only a block taller than
// kRows*R or wider than 32 vectors reads its lines a second time (usually
// from L1 or L2).
template <typename T, int VB, bool kMask>
__device__ __forceinline__ void strip_pass(const T* __restrict__ x, T* __restrict__ y,
                                           int8_t* __restrict__ bitmap, const Strip& s) {
  constexpr int V = VB / (int)sizeof(T);          // elements per vector
  const int G = 1 << s.lg, R = 1 << s.lgr;
  const int c = threadIdx.x & ((1 << s.lgc) - 1);  // vector column in the block
  const int h = (threadIdx.x & (G - 1)) >> s.lgc;  // first row
  const bool lead = (threadIdx.x & (G - 1)) == 0;
  const uint32_t t0 = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t warp0 = t0 & ~31u;               // the warp's first lane
  const uint32_t dg = (gridDim.x * kThreads) >> s.lg;
  const int dr = (int)(dg / (uint32_t)s.nk), dk = (int)(dg % (uint32_t)s.nk);
  int64_t g = t0 >> s.lg, gw = warp0 >> s.lg;
  int64_t r = (uint32_t)g / (uint32_t)s.nk;
  int k = (int)((uint32_t)g % (uint32_t)s.nk);
  const bool single = s.P == 1 && s.bs <= kRows * R;  // the block in registers
  for (; gw < s.nb; gw += dg, g += dg, r += dr, k += dk) {
    if (k >= s.nk) { k -= s.nk; ++r; }
    const bool valid = g < s.nb;
    const int64_t base = r * s.bs * s.K + (int64_t)k * s.bc + (int64_t)c * V;
    Vec<VB> held[kRows];
    uint32_t m = 0;                                // +0: the identity of max|x|
    for (int p = 0; p < s.P; ++p) {
      const bool on = valid && c + (p << s.lgc) < s.L;
      const T* src = x + base + (int64_t)(p << s.lgc) * V;
      for (int r0 = h; r0 < s.bs; r0 += kRows * R) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (on && r0 + i * R < s.bs) {
            held[i] = load_vec<VB>(src + (r0 + i * R) * s.K);
          } else {
#pragma unroll
            for (int w = 0; w < Vec<VB>::W; ++w) held[i].w[w] = 0u;
          }
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
#pragma unroll
          for (int w = 0; w < Vec<VB>::W; ++w) m = Elem<T>::absmax(m, held[i].w[w]);
        }
      }
    }
    m = Elem<T>::fold(m);
    for (int off = G >> 1; off > 0; off >>= 1) m = max(m, __shfl_xor_sync(kFull, m, off));
    const bool keep = Elem<T>::value(m) >= s.thr;  // NaN compares false: dead
    if (valid && lead) bitmap[g] = keep ? 1 : 0;
    if constexpr (kMask) {
      const float kf = keep ? 1.0f : 0.0f;
      if (single) {
        if (valid && c < s.L) {
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const int row = h + i * R;
            if (row < s.bs) {
              store_vec<VB>(y + base + row * s.K, scale_vec<T, VB>(held[i], kf));
            }
          }
        }
      } else {
        for (int p = 0; p < s.P; ++p) {
          if (!valid || c + (p << s.lgc) >= s.L) continue;
          const int64_t off = base + (int64_t)(p << s.lgc) * V;
          for (int i = h; i < s.bs; i += R) {
            store_vec<VB>(y + off + i * s.K,
                          scale_vec<T, VB>(load_vec<VB>(x + off + i * s.K), kf));
          }
        }
      }
    }
  }
}

// Phase 1: keep[g] = max|x| over block g >= thr (thr already rounded to the
// map's dtype). y is not read.
template <typename T, int VB>
__global__ void __launch_bounds__(kThreads, 4)
zebra_bitmap_kernel(const T* __restrict__ x, T* __restrict__ y,
                    int8_t* __restrict__ bitmap, Strip s) {
  strip_pass<T, VB, false>(x, y, bitmap, s);
}

// One pass of the `pallas` backend: keep[g] as the comparator computes it,
// then y = x * keep over the block.
template <typename T, int VB>
__global__ void __launch_bounds__(kThreads, 4)
zebra_mask_kernel(const T* __restrict__ x, T* __restrict__ y,
                  int8_t* __restrict__ bitmap, Strip s) {
  strip_pass<T, VB, true>(x, y, bitmap, s);
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

// The widest vector (16, 8, 4 or 2 bytes, at least one element) that
// divides a block row, a map row and both data pointers (y may be null).
int vec_bytes(int item, int bc, int64_t K, const void* x, const void* y) {
  for (int vb = 16; vb > item; vb >>= 1) {
    if ((int64_t)bc * item % vb == 0 && K * item % vb == 0 &&
        reinterpret_cast<uintptr_t>(x) % vb == 0 &&
        reinterpret_cast<uintptr_t>(y) % vb == 0) {
      return vb;
    }
  }
  return item;
}

// Enough CTAs to fill every SM at the kernel's occupancy, and no more than
// the work needs; the kernel grid-strides beyond.
template <typename T, int VB, bool kMask>
int launch_strip(const void* x, void* y, void* bitmap, const Strip& s,
                 cudaStream_t stream) {
  auto kernel = kMask ? &zebra_mask_kernel<T, VB> : &zebra_bitmap_kernel<T, VB>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int64_t cap = (int64_t)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 132);
  const int64_t want = ((s.nb << s.lg) + kThreads - 1) / kThreads;
  kernel<<<(int)(want < cap ? want : cap), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), static_cast<int8_t*>(bitmap), s);
  return (int)cudaGetLastError();
}

template <typename T, bool kMask>
int strip_typed(const void* x, void* y, void* bitmap, int64_t M, int64_t K, int bs,
                int bc, float thr, cudaStream_t stream) {
  constexpr int item = (int)sizeof(T);
  const int vb = vec_bytes(item, bc, K, x, y);
  Strip s;
  s.nk = (int)(K / bc);
  s.nb = (M / bs) * s.nk;
  s.K = K;
  s.bs = bs;
  s.bc = bc;
  s.L = bc * item / vb;
  s.lgc = 0;
  while ((1 << s.lgc) < s.L && s.lgc < 5) ++s.lgc;
  s.P = (s.L + (1 << s.lgc) - 1) >> s.lgc;
  // rows split among R lanes until R rows fill a 128-byte line (bs a
  // multiple of R, G at most 32)
  s.lgr = 0;
  while ((K * item << s.lgr) < 128 && s.bs % (2 << s.lgr) == 0 && s.lgc + s.lgr < 5) {
    ++s.lgr;
  }
  s.lg = s.lgc + s.lgr;
  s.thr = thr;
  if (s.nb == 0) return 0;
  switch (vb) {
    case 16: return launch_strip<T, 16, kMask>(x, y, bitmap, s, stream);
    case 8: return launch_strip<T, 8, kMask>(x, y, bitmap, s, stream);
    case 4: return launch_strip<T, 4, kMask>(x, y, bitmap, s, stream);
    default:
      if constexpr (item == 2) return launch_strip<T, 2, kMask>(x, y, bitmap, s, stream);
      return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.
template <bool kMask>
int strip_launch(const void* x, void* y, void* bitmap, int64_t M, int64_t K, int bs,
                 int bc, float thr, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return strip_typed<float, kMask>(x, y, bitmap, M, K, bs, bc, thr, st);
    case 1: return strip_typed<__nv_bfloat16, kMask>(x, y, bitmap, M, K, bs, bc, thr, st);
    case 2: return strip_typed<__half, kMask>(x, y, bitmap, M, K, bs, bc, thr, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.
int zebra_bitmap_launch(const void* x, void* bitmap, long long M, long long K,
                        int bs, int bc, float thr, int dtype, void* stream) {
  return strip_launch<false>(x, nullptr, bitmap, M, K, bs, bc, thr, dtype, stream);
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

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.
int zebra_mask_launch(const void* x, void* y, void* bitmap, long long M,
                      long long K, int bs, int bc, float thr, int dtype,
                      void* stream) {
  return strip_launch<true>(x, y, bitmap, M, K, bs, bc, thr, dtype, stream);
}

}  // extern "C"
