// Zebra kernels for Hopper (sm_90a): the comparator, the pack pass and the
// expander of the `stream` site backend, and the one-pass masking kernel of
// the `pallas` backend.
//
// Each kernel replaces one Pallas TPU kernel of src/repro/kernels:
//   zebra_bitmap_kernel  <- mask_pack.py::_bitmap_kernel       (phase 1)
//   zebra_pack_kernel    <- mask_pack.py::_gather_pack_kernel  (phase 2b)
//                           and pack.py::_pack_kernel (the codec's pack,
//                           under a bitmap given from outside)
//   zebra_unpack_kernel  <- pack.py::_unpack_kernel
//   zebra_mask_kernel    <- zebra_mask.py::_zebra_mask_kernel
// and is held bit for bit against its plain PyTorch version
// (kernels/mask_pack.py, kernels/pack.py, kernels/zebra_mask.py).
//
// Layout: x is a row-major (M, K) map cut into (bs, bc) Zebra blocks, block
// g = r * nk + k at rows [r*bs, (r+1)*bs) and columns [k*bc, (k+1)*bc).
// The payload is (nb, bs, bc): slot s holds one block, row-major inside, so
// a slot is one contiguous run of bs*bc*item bytes. bs and bc are runtime
// ints, so one build serves 8x8, 4x4 and 2x2 CNN blocks and 8x128 token
// blocks. The comparator and the masking kernel take float32, bfloat16 and
// float16; pack and unpack move 2- or 4-byte elements as unsigned words,
// whatever they hold (NaN payloads and -0.0 survive exactly).
//
// All four kernels are bound by device-memory bytes, not by arithmetic:
//   comparator: the map read once + the int8 bitmap written;
//   pack:       the live blocks read + the bitmap and the live blocks' slot
//               entries read + the whole (nb, bs, bc) payload written, zero
//               tail included;
//   unpack:     the live payload blocks read + the bitmap and the live
//               blocks' slot entries read + the (M, K) map written;
//   mask:       the map read + the masked map and the int8 bitmap written.
// Pack and unpack compute nothing at all, so the only gain is bytes in
// flight and whole-line accesses.
//
// All four are strip-mapped streaming kernels on one lane mapping
// (StripLane below): a group of lanes owns a block, a lane one vector
// column of it, and the lane issues its loads from every row of the block
// (or every R-th row of a narrow map) before it uses any, so up to 8 wide
// loads (4 in pack and unpack) are in flight per lane. The comparator
// reduces them (strip_pass); the masking kernel also writes y from the same
// registers; pack stores them to the block's slot and unpack stores a
// slot's rows (or +0 for a dead block) into the block's place in the map.
// Blocks run in no order on the card, so the TPU pack kernel's "live write
// wins" ordering does not exist here: the pack kernel scatters each live
// block to its own slot (live slots are a bijection onto [0, n_live)) and
// then, in a flat phase of the same launch, writes zeros over slots
// [n_live, nb): two disjoint sets of writes.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch. The wrappers count launches:
// mask_pack.zebra_bitmap.launches, mask_pack.pack_blocks.launches,
// pack.zebra_pack.launches, pack.zebra_unpack.launches and
// zebra_mask.zebra_mask.launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;      // block rows a lane holds in registers at once
constexpr int kMoveRows = 4;  // the same for pack and unpack: with 8, their
                              // store side spilled at 64 registers
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// The strip mapping, shared by all four kernels
// ---------------------------------------------------------------------------
//
// A block row of bc elements is VB-byte vectors: VB = 16, 8, 4 or 2, the
// widest that divides bc*item, K*item and the data pointers (vec_bytes), so
// no vector straddles two blocks. A block's L = bc*item/VB vector columns
// go to Lc lanes, Lc = L rounded up to a power of two and capped at 32
// (lanes c >= L idle when L is not a power of two); lane c owns columns c,
// c+Lc, ... . Groups of G = Lc lanes sit on consecutive blocks of a block
// row, so a warp load reads whole 32-byte sectors, 512 B at VB 16. A map
// row narrower than a 128-byte line (the CNN's late maps: 32 or 64 bytes)
// would leave each warp load a scatter of part-lines, so there R = 2, 4 or
// 8 lanes split a block's rows (lane (c, h) loads rows h, h+R, ...),
// G = Lc*R, and a warp load covers R whole rows of each of its strips:
// whole lines. Pack and unpack also split until R rows of one block fill a
// 128-byte line, because a slot holds the block's rows end to end: a
// group's store (pack) or load (unpack) of a slot then covers whole lines
// too. Indices: one 32-bit divide per thread at its start, then the (block
// row, block column) pair steps by constants over the grid-stride loop; no
// division per element or per block.

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
  float thr;                  // T_obj in the map's dtype (comparator, mask)
};

// A lane's place in the strip mapping: its vector column c and first row h
// in its group's block, and that block g as (block row r, block column k).
// step() moves every lane of the grid on by the grid's dg blocks.
struct StripLane {
  int c, h;
  bool lead;                  // the group's first lane
  uint32_t dg;                // blocks per grid step
  int dr, dk;                 // dg as whole block rows + block columns
  int64_t g, gw;              // the lane's block; its warp's first block
  int64_t r;
  int k;

  __device__ __forceinline__ explicit StripLane(const Strip& s) {
    const int G = 1 << s.lg;
    c = threadIdx.x & ((1 << s.lgc) - 1);
    h = (threadIdx.x & (G - 1)) >> s.lgc;
    lead = (threadIdx.x & (G - 1)) == 0;
    const uint32_t t0 = blockIdx.x * kThreads + threadIdx.x;
    dg = (gridDim.x * kThreads) >> s.lg;
    dr = (int)(dg / (uint32_t)s.nk);
    dk = (int)(dg % (uint32_t)s.nk);
    g = t0 >> s.lg;
    gw = (t0 & ~31u) >> s.lg;
    r = (uint32_t)g / (uint32_t)s.nk;
    k = (int)((uint32_t)g % (uint32_t)s.nk);
  }

  __device__ __forceinline__ void step(const Strip& s) {
    gw += dg;
    g += dg;
    r += dr;
    k += dk;
    if (k >= s.nk) { k -= s.nk; ++r; }
  }

  // the map offset, in elements, of the lane's first vector (row 0)
  __device__ __forceinline__ int64_t base(const Strip& s, int V) const {
    return r * s.bs * s.K + (int64_t)k * s.bc + (int64_t)c * V;
  }
};

template <int VB>
struct Vec {                  // the bits of one vector; VB 2: the low half of w[0]
  static constexpr int W = VB >= 4 ? VB / 4 : 1;
  uint32_t w[W];
};

template <int VB>
__device__ __forceinline__ Vec<VB> zero_vec() {
  Vec<VB> v;
#pragma unroll
  for (int i = 0; i < Vec<VB>::W; ++i) v.w[i] = 0u;
  return v;
}

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

// ---------------------------------------------------------------------------
// The comparator and the masking kernel
// ---------------------------------------------------------------------------
//
// max|x| as ordered unsigned bits: with the sign bit cleared, the bits of
// every non-NaN value order as its magnitude, and every NaN lies above
// +Inf. So the unsigned max of these bits is the block's max|x|, or a NaN
// when the block holds one, as jnp.max and torch.amax give it: a NaN block
// compares false and is dead. Max is exact in any order, so the bitmap does
// not depend on the tiling. 16-bit types reduce two halves per instruction
// (__vmaxu2).

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

// The comparator (kMask false) and the masking kernel (kMask true). The
// group's lanes reduce with lg xor-shuffles, inside their aligned group of
// G lanes, never across a block boundary, so the loop runs while any block
// of the warp is left (gw). Lane 0 of the group writes the bitmap byte. The
// masking kernel writes y = x * keep, the product and not a select (as the
// Pallas kernel and the plain version compute it: a dead block of negative
// values gives -0.0, one holding NaN or Inf gives NaN), from the vectors
// the lane already holds; only a block taller than kRows*R or wider than 32
// vectors reads its lines a second time (usually from L1 or L2).
template <typename T, int VB, bool kMask>
__device__ __forceinline__ void strip_pass(const T* __restrict__ x, T* __restrict__ y,
                                           int8_t* __restrict__ bitmap, const Strip& s) {
  constexpr int V = VB / (int)sizeof(T);          // elements per vector
  const int G = 1 << s.lg, R = 1 << s.lgr;
  StripLane t(s);
  const bool single = s.P == 1 && s.bs <= kRows * R;  // the block in registers
  for (; t.gw < s.nb; t.step(s)) {
    const bool valid = t.g < s.nb;
    const int64_t base = t.base(s, V);
    Vec<VB> held[kRows];
    uint32_t m = 0;                                // +0: the identity of max|x|
    for (int p = 0; p < s.P; ++p) {
      const bool on = valid && t.c + (p << s.lgc) < s.L;
      const T* src = x + base + (int64_t)(p << s.lgc) * V;
      for (int r0 = t.h; r0 < s.bs; r0 += kRows * R) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (on && r0 + i * R < s.bs) {
            held[i] = load_vec<VB>(src + (r0 + i * R) * s.K);
          } else {
            held[i] = zero_vec<VB>();
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
    if (valid && t.lead) bitmap[t.g] = keep ? 1 : 0;
    if constexpr (kMask) {
      const float kf = keep ? 1.0f : 0.0f;
      if (single) {
        if (valid && t.c < s.L) {
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const int row = t.h + i * R;
            if (row < s.bs) {
              store_vec<VB>(y + base + row * s.K, scale_vec<T, VB>(held[i], kf));
            }
          }
        }
      } else {
        for (int p = 0; p < s.P; ++p) {
          if (!valid || t.c + (p << s.lgc) >= s.L) continue;
          const int64_t off = base + (int64_t)(p << s.lgc) * V;
          for (int i = t.h; i < s.bs; i += R) {
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

// ---------------------------------------------------------------------------
// Pack and unpack
// ---------------------------------------------------------------------------
//
// Both move blocks between the map and the payload on the strip mapping:
// the group on block g reads bitmap[g] (every lane the same word, one
// broadcast load) and, only for a live block, slot[g]; a lane then issues
// all its rows' vector loads before any store, and the group's accesses to
// the slot cover its contiguous bytes in whole lines. U is an unsigned word
// of the element's size.

// Phase 2b and the codec's pack: payload[slot[g]] <- block g for every live
// g; then, after the block loop, every thread of the grid grid-strides over
// slots [n_live, nb) as one flat run of VB-wide zero stores (n_live read
// from the device: the host never knows it). A dead block issues no load
// and no store.
template <typename U, int VB>
__global__ void __launch_bounds__(kThreads, 4)
zebra_pack_kernel(const U* __restrict__ x, const int8_t* __restrict__ bitmap,
                  const int32_t* __restrict__ slot, const int32_t* __restrict__ n_live_ptr,
                  U* __restrict__ payload, Strip s) {
  constexpr int V = VB / (int)sizeof(U);
  const int R = 1 << s.lgr;
  const int64_t blk = (int64_t)s.bs * s.bc;       // elements of a block
  const int64_t xstep = (int64_t)R * s.K;         // a lane's next row, map side
  const int pstep = R * s.bc;                     // and slot side
  StripLane t(s);
  for (; t.g < s.nb; t.step(s)) {
    if (!bitmap[t.g]) continue;
    const U* src = x + t.base(s, V);
    U* dst = payload + (int64_t)__ldg(slot + t.g) * blk + t.c * V;
    for (int p = 0; p < s.P && t.c + (p << s.lgc) < s.L; ++p) {
      const int col = (p << s.lgc) * V;
      for (int r0 = t.h; r0 < s.bs; r0 += kMoveRows * R) {
        Vec<VB> held[kMoveRows];
        const U* from = src + col + r0 * s.K;
#pragma unroll
        for (int i = 0; i < kMoveRows; ++i, from += xstep) {
          if (r0 + i * R < s.bs) held[i] = load_vec<VB>(from);
        }
        U* to = dst + col + r0 * s.bc;
#pragma unroll
        for (int i = 0; i < kMoveRows; ++i, to += pstep) {
          if (r0 + i * R < s.bs) store_vec<VB>(to, held[i]);
        }
      }
    }
  }
  const int64_t end = s.nb * blk / V;             // the payload in vectors
  const Vec<VB> zero = zero_vec<VB>();
  for (int64_t v = __ldg(n_live_ptr) * blk / V + blockIdx.x * kThreads + threadIdx.x;
       v < end; v += (int64_t)gridDim.x * kThreads) {
    store_vec<VB>(payload + v * V, zero);
  }
}

// Expander: out block g <- keep[g] ? payload[slot[g]] : +0, every byte of
// out written once. A dead block's slot aliases a live slot of its column;
// it is never read, and its zeros come from a select, never from a product
// (which would leak NaN/Inf or -0.0 from the aliased block).
template <typename U, int VB>
__global__ void __launch_bounds__(kThreads, 4)
zebra_unpack_kernel(const U* __restrict__ payload, const int8_t* __restrict__ bitmap,
                    const int32_t* __restrict__ slot, U* __restrict__ out, Strip s) {
  constexpr int V = VB / (int)sizeof(U);
  const int R = 1 << s.lgr;
  const int64_t blk = (int64_t)s.bs * s.bc;
  const int pstep = R * s.bc;                     // a lane's next row, slot side
  const int64_t ystep = (int64_t)R * s.K;         // and map side
  StripLane t(s);
  for (; t.g < s.nb; t.step(s)) {
    const bool live = bitmap[t.g] != 0;
    const U* src = payload + (live ? (int64_t)__ldg(slot + t.g) * blk : 0) + t.c * V;
    U* dst = out + t.base(s, V);
    for (int p = 0; p < s.P && t.c + (p << s.lgc) < s.L; ++p) {
      const int col = (p << s.lgc) * V;
      for (int r0 = t.h; r0 < s.bs; r0 += kMoveRows * R) {
        Vec<VB> held[kMoveRows];
        const U* from = src + col + r0 * s.bc;
#pragma unroll
        for (int i = 0; i < kMoveRows; ++i, from += pstep) {
          if (r0 + i * R < s.bs) held[i] = live ? load_vec<VB>(from) : zero_vec<VB>();
        }
        U* to = dst + col + r0 * s.K;
#pragma unroll
        for (int i = 0; i < kMoveRows; ++i, to += ystep) {
          if (r0 + i * R < s.bs) store_vec<VB>(to, held[i]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The widest vector (16, 8, 4 or 2 bytes, at least one element) that
// divides a block row, a map row and both data pointers (b may be null).
int vec_bytes(int item, int bc, int64_t K, const void* a, const void* b) {
  for (int vb = 16; vb > item; vb >>= 1) {
    if ((int64_t)bc * item % vb == 0 && K * item % vb == 0 &&
        reinterpret_cast<uintptr_t>(a) % vb == 0 &&
        reinterpret_cast<uintptr_t>(b) % vb == 0) {
      return vb;
    }
  }
  return item;
}

// The strip mapping of an (M, K) map of item-byte elements in vb-byte
// vectors. `slots`: the kernel moves whole blocks to or from payload slots
// (pack, unpack), so R also grows until R rows of a block fill a line.
Strip strip_geometry(int item, int vb, int64_t M, int64_t K, int bs, int bc, bool slots) {
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
  while (((K * item << s.lgr) < 128 || (slots && ((int64_t)bc * item << s.lgr) < 128)) &&
         s.bs % (2 << s.lgr) == 0 && s.lgc + s.lgr < 5) {
    ++s.lgr;
  }
  s.lg = s.lgc + s.lgr;
  s.thr = 0.0f;
  return s;
}

// f(std::integral_constant<int, vb>) for the vector width vb; 2-byte
// vectors only for 2-byte elements.
template <int item, typename F>
int with_vec(int vb, F&& f) {
  switch (vb) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 4: return f(std::integral_constant<int, 4>{});
    default:
      if constexpr (item == 2) return f(std::integral_constant<int, 2>{});
      return (int)cudaErrorInvalidValue;
  }
}

// Enough CTAs to fill every SM at the kernel's occupancy, and no more than
// the work needs; the kernel grid-strides beyond.
template <typename... Params, typename... Args>
int launch_strip(void (*kernel)(Params...), const Strip& s, cudaStream_t stream,
                 Args... args) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int64_t cap = (int64_t)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 132);
  const int64_t want = ((s.nb << s.lg) + kThreads - 1) / kThreads;
  kernel<<<(int)(want < cap ? want : cap), kThreads, 0, stream>>>(args..., s);
  return (int)cudaGetLastError();
}

template <typename T, bool kMask>
int strip_typed(const void* x, void* y, void* bitmap, int64_t M, int64_t K, int bs,
                int bc, float thr, cudaStream_t stream) {
  constexpr int item = (int)sizeof(T);
  const int vb = vec_bytes(item, bc, K, x, y);
  Strip s = strip_geometry(item, vb, M, K, bs, bc, false);
  s.thr = thr;
  if (s.nb == 0) return 0;
  return with_vec<item>(vb, [&](auto v) {
    constexpr int VB = decltype(v)::value;
    auto kernel = kMask ? &zebra_mask_kernel<T, VB> : &zebra_bitmap_kernel<T, VB>;
    return launch_strip(kernel, s, stream, static_cast<const T*>(x), static_cast<T*>(y),
                        static_cast<int8_t*>(bitmap));
  });
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

template <typename U>
int pack_typed(const void* x, const void* bitmap, const void* slot, const void* n_live,
               void* payload, int64_t M, int64_t K, int bs, int bc, cudaStream_t stream) {
  constexpr int item = (int)sizeof(U);
  const int vb = vec_bytes(item, bc, K, x, payload);
  const Strip s = strip_geometry(item, vb, M, K, bs, bc, true);
  if (s.nb == 0) return 0;
  return with_vec<item>(vb, [&](auto v) {
    return launch_strip(&zebra_pack_kernel<U, decltype(v)::value>, s, stream,
                        static_cast<const U*>(x), static_cast<const int8_t*>(bitmap),
                        static_cast<const int32_t*>(slot),
                        static_cast<const int32_t*>(n_live), static_cast<U*>(payload));
  });
}

template <typename U>
int unpack_typed(const void* payload, const void* bitmap, const void* slot, void* out,
                 int64_t M, int64_t K, int bs, int bc, cudaStream_t stream) {
  constexpr int item = (int)sizeof(U);
  const int vb = vec_bytes(item, bc, K, payload, out);
  const Strip s = strip_geometry(item, vb, M, K, bs, bc, true);
  if (s.nb == 0) return 0;
  return with_vec<item>(vb, [&](auto v) {
    return launch_strip(&zebra_unpack_kernel<U, decltype(v)::value>, s, stream,
                        static_cast<const U*>(payload), static_cast<const int8_t*>(bitmap),
                        static_cast<const int32_t*>(slot), static_cast<U*>(out));
  });
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 4: return pack_typed<uint32_t>(x, bitmap, slot, n_live, payload, M, K, bs, bc, st);
    case 2: return pack_typed<uint16_t>(x, bitmap, slot, n_live, payload, M, K, bs, bc, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int zebra_unpack_launch(const void* payload, const void* bitmap,
                        const void* slot, void* out, long long M, long long K,
                        int bs, int bc, int itemsize, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (itemsize) {
    case 4: return unpack_typed<uint32_t>(payload, bitmap, slot, out, M, K, bs, bc, st);
    case 2: return unpack_typed<uint16_t>(payload, bitmap, slot, out, M, K, bs, bc, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.
int zebra_mask_launch(const void* x, void* y, void* bitmap, long long M,
                      long long K, int bs, int bc, float thr, int dtype,
                      void* stream) {
  return strip_launch<true>(x, y, bitmap, M, K, bs, bc, thr, dtype, stream);
}

}  // extern "C"
