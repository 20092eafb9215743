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
// of the (nb, bs, bc) stream. For each dtype the two kernels run one device
// body, templated on that block accessor (and, for the 16-bit types, on how the w panel
// is staged, which changes no value), so they are equal bit for bit (the
// counterpart of the Pallas `gemm_supertile_body`). Each is held against
// its plain PyTorch version (kernels/zebra_spmm.py, kernels/spmm_cs.py) to a
// tolerance: the plain version is one fp32 matmul, which sums in another
// order.
//
// The dtype picks the body at launch, the same for both kernels:
//
// * bfloat16 (the served path) and float16: `mma_block_rows<T>`, on the
//   tensor cores with mma.sync m16n8k16 T x T -> fp32 (one instantiation
//   per 16-bit type; they differ only in the MMA's operand type). The product is taken as
//   y^T = w^T x^T ("swap A/B"): A is a 16(n) x 16(k) tile of w^T, read with
//   ldmatrix.x4.trans from the row-major w panel in shared memory; B is the
//   8 rows of ONE block row over 16 k, which in the MMA's "col" layout is
//   x's own row-major layout (plain ldmatrix); D is 16 output columns x 8
//   rows. So a block row is exactly the MMA's n8 side, and a dead block
//   issues no MMA and reads no payload.
//   A CTA covers kBlockRowsTc block rows x kTileNTc output columns; each of
//   its kWarpsM x kWarpsN warps owns kWarpRows block rows x kWarpTiles
//   16-column tiles. The CTA walks its live K-block columns in ascending
//   order, kStageK elements a stage, through a kStages-deep ring filled by
//   cp.async (16-byte copies, zero-filled where a row, column or k lies
//   outside the operand); a column whose CTA rows are all dead is skipped
//   with its w panel. The CTA's keep map is loaded into shared memory once,
//   one row mask per K-block column. Shared rows are XOR-swizzled in
//   16-byte chunks, so ldmatrix reads them without bank conflicts.
//   What bounds it at the LM's shapes is latency (PERF.md): control flow
//   between two MMAs makes the second wait for the first, so testing each
//   row at each k16 step ran at about a third of the rate of straight-line
//   MMAs. A warp's rows therefore go in groups of 4, and each group runs
//   the straight-line body of its live pattern (one of 15), once per group
//   and half stage, after the half stage's A fragments are loaded. Two CTAs
//   share an SM (<= 128 registers a thread, two rings) to hide the rest.
//   Rows r >= bs of a block are zero in shared memory and their outputs are
//   never stored; when bc % 16 == 8 the last k16 step of a block has its
//   upper 8 k zero in both operands; a stage shorter than kStageK (bc % 64
//   != 0) tests each row at each step instead of dispatching. bc must be a
//   multiple of 8 (16-byte rows for cp.async); the wrapper raises
//   otherwise, and no 16-bit caller has such a block. When N % 8 != 0 the w
//   rows are not 16-byte aligned and the panel is staged by element loads
//   instead (the same values). Every output's fp32 accumulator sees the
//   same MMA sequence (the k16 steps of its live blocks, ascending K) in
//   both kernels and on both paths, whatever the tile choice. Bounded by
//   2 * n_live * bs * bc * N tensor-core operations; the w panel is read
//   from L2 again for every kBlockRowsTc block rows.
//
// * float32 (edge cases and tests only; TF32 would break their 1e-4
//   tolerance): `fma_block_rows`, on the CUDA cores. One CTA per (group of
//   kWarps block rows, kTileN output columns); warp w owns block row i and
//   keeps its bs x 4 outputs per lane in fp32 registers; a live block and
//   the w panel are staged kChunk K elements at a time through shared
//   memory, and every lane does one fmaf per output per k, in ascending k.
//
// The skip rule, in both bodies: a dead block is never read and contributes
// nothing; no product with its w panel is formed. So NaN/Inf in the w rows
// of a dead block does not reach the rows of that block (the plain version,
// which multiplies the zeroed block, gives NaN there). Bitwise 6 == 7 holds
// whatever w holds.
//
// Every entry point launches on the caller's stream, allocates nothing, does
// not synchronise, and returns the first CUDA error (cudaErrorInvalidValue
// for a shape or alignment it does not take). The wrappers count launches
// in zebra_spmm.zebra_spmm.launches and spmm_cs.zebra_spmm_cs.launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

constexpr int kMaxBs = 8;                 // block rows (of M) in registers

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

// ---------------------------------------------------------------------------
// float32: the CUDA-core body
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;                 // block rows per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kTileN = 128;               // output columns per CTA, 4 per lane
constexpr int kChunk = 32;                // K elements staged per step

template <typename Blocks>
__device__ __forceinline__ void fma_block_rows(
    const Blocks& blocks, const int8_t* __restrict__ bitmap,
    const float* __restrict__ w, float* __restrict__ y, int64_t nm, int64_t nk,
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
    const float* blk = live ? blocks.block(i, kc, nk) : nullptr;
    for (int k0 = 0; k0 < bc; k0 += kChunk) {
      const int len = min(kChunk, bc - k0);
      const float* wrow = w + (kc * bc + k0) * N;
      for (int e = threadIdx.x; e < kChunk * kTileN; e += kThreads) {
        const int kk = e / kTileN, c = e % kTileN;
        const int64_t n = n0 + c;
        ws[kk][c] = (kk < len && n < N) ? wrow[kk * N + n] : 0.0f;
      }
      if (live) {
        for (int e = lane; e < kChunk * kMaxBs; e += 32) {
          const int r = e / kChunk, kk = e % kChunk;
          xs[warp][kk][r] = (r < bs && kk < len) ? blk[r * stride + k0 + kk] : 0.0f;
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

// ---------------------------------------------------------------------------
// bfloat16 and float16: the tensor-core body
// ---------------------------------------------------------------------------

constexpr int kBlockRowsTc = 16;          // block rows per CTA
constexpr int kTileNTc = 128;             // output columns per CTA
constexpr int kWarpsM = 2;                // warps splitting the CTA's block rows
constexpr int kWarpTiles = 2;             // 16-column MMA tiles per warp
constexpr int kStageK = 64;               // K elements per ring stage
constexpr int kStages = 3;                // ring depth
constexpr int kSteps = kStageK / 16;                 // k16 steps per stage
constexpr int kParts = 2;                 // dispatches per group and stage
constexpr int kPartSteps = kSteps / kParts;          // k16 steps per dispatch
constexpr int kWarpRows = kBlockRowsTc / kWarpsM;    // block rows per warp
constexpr int kWarpsN = kTileNTc / (16 * kWarpTiles);
constexpr int kThreadsTc = kWarpsM * kWarpsN * 32;
constexpr int kWRow = kTileNTc * 2;                  // bytes of a staged w row
constexpr int kXRow = kStageK * 2;                   // bytes of a staged block row
constexpr int kWBytes = kStageK * kWRow;             // the w panel of a stage
constexpr int kXBlock = kMaxBs * kXRow;              // one staged block
constexpr int kStageBytes = kWBytes + kBlockRowsTc * kXBlock;
constexpr int kRingBytes = kStages * kStageBytes;
constexpr int kMaxSmem = 232448;          // sm_90's opt-in shared memory per CTA
static_assert(kBlockRowsTc <= 32 && kWarpRows % 4 == 0, "rows come in groups of 4");
static_assert(kStageK % 64 == 0 && kTileNTc % 64 == 0, "the swizzle needs 8-chunk rows");
static_assert(kThreadsTc % kBlockRowsTc == 0 &&
              (kBlockRowsTc * kMaxBs * kStageK / 8) % kThreadsTc == 0, "block staging");
static_assert((kStageK * kTileNTc / 8) % kThreadsTc == 0, "w staging");

template <typename T>
constexpr int kThreadsOf = std::is_same<T, float>::value ? kThreads : kThreadsTc;
// two 16-bit CTAs share an SM (registers <= 128 a thread, 2 x the ring in
// shared memory): a warp waits on ldmatrix and MMA latency, so warps count
template <typename T>
constexpr int kCtasPerSmOf = std::is_same<T, float>::value ? 1 : 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; the bytes past src_bytes (all
// 16 when src_bytes is 0, and then nothing is read) are zero
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}
// d += a (16 x 16, row) * b (16 x 8, col), T (bf16 or f16) in, fp32 accumulate
template <typename T>
__device__ __forceinline__ void mma_tc(float (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  if constexpr (std::is_same<T, bf16>::value)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Byte offsets in a stage: 16-byte chunk c of w row k, and of row r of
// staged block b; the chunk index is XORed with the row's low 3 bits, so
// the 8 rows an ldmatrix phase reads fall in 8 different bank groups.
__device__ __forceinline__ uint32_t w_off(int k, int c) {
  return k * kWRow + ((c ^ (k & 7)) << 4);
}
__device__ __forceinline__ uint32_t x_off(int b, int r, int c) {
  return kWBytes + b * kXBlock + r * kXRow + ((c ^ r) << 4);
}

// Issue one stage: w rows kc*bc + k0 + [0, kStageK) x columns n0 +
// [0, kTileNTc), and the live blocks of the CTA over the same k; rows past
// the block's end (k >= len), columns past N and block rows r >= bs are zero.
template <typename T, bool kAlignedW, typename Blocks>
__device__ __forceinline__ void stage_load(
    uint32_t st, const Blocks& blocks, const T* __restrict__ w,
    uint32_t rows, int64_t i0, int64_t kc, int k0, int len, int64_t nk,
    int64_t N, int64_t n0, int bs, int bc) {
  constexpr int kWChunks = kTileNTc / 8;              // per w row
  for (int e = threadIdx.x; e < kStageK * kWChunks; e += kThreadsTc) {
    const int k = e / kWChunks, c = e % kWChunks;
    const int64_t n = n0 + c * 8;
    const T* src = w + (kc * bc + k0 + k) * N + n;
    if constexpr (kAlignedW) {
      const bool in = k < len && n < N;
      cp_async16(st + w_off(k, c), in ? src : w, in ? 16 : 0);
    } else {
      // rows of w are not 16-byte aligned: stage them by element loads,
      // a 4-byte word at a time
      const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
#pragma unroll 1
      for (int j = 0; j < 4; ++j) {
        const uint32_t lo = (k < len && n + 2 * j < N) ? s[2 * j] : 0u;
        const uint32_t hi = (k < len && n + 2 * j + 1 < N) ? s[2 * j + 1] : 0u;
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(st + w_off(k, c) + 4 * j),
                     "r"(lo | (hi << 16)));
      }
    }
  }
  constexpr int kRowChunks = kStageK / 8;             // per block row of M
  constexpr int kPerThread = kBlockRowsTc * kMaxBs * kRowChunks / kThreadsTc;
  constexpr int kThreadsPerBlock = kThreadsTc / kBlockRowsTc;
  const int b = threadIdx.x / kThreadsPerBlock;
  if (!((rows >> b) & 1u)) return;                    // dead: never read
  const T* blk = blocks.block(i0 + b, kc, nk);
  const int64_t stride = blocks.row_stride();
  const int first = (threadIdx.x % kThreadsPerBlock) * kPerThread;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int r = (first + j) / kRowChunks, c = (first + j) % kRowChunks;
    const bool in = r < bs && c * 8 < len;
    cp_async16(st + x_off(b, r, c), in ? blk + r * stride + k0 + c * 8 : w,
               in ? 16 : 0);
  }
}

using Acc = float[kWarpRows][kWarpTiles][4];
using AFrags = uint32_t[kPartSteps][kWarpTiles][4];

// A full stage of rows 4G..4G+3 of the warp whose live bits are kLive: per
// k16 step, the live rows' B fragments (their 8 rows x 16 k at xbase +
// row * kXBlock, swizzled chunk (2 ks + cb) ^ rb), then every MMA of them,
// all straight-line. Control flow costs tens of cycles a point with two
// warps per scheduler, so a stage has one dispatch per group, not one test
// per row and step.
template <typename T, int G, uint32_t kLive>
__device__ __forceinline__ void group_stage(Acc& acc, const AFrags& a, uint32_t xbase,
                                            int ks0, int rb, int cb) {
#pragma unroll
  for (int ks = 0; ks < kPartSteps; ++ks) {
    uint32_t b[4][2];
    const uint32_t xk = xbase + (((2 * (ks0 + ks) + cb) ^ rb) << 4);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if ((kLive >> r) & 1u) ldmatrix_x2(b[r], xk + (4 * G + r) * kXBlock);
#pragma unroll
    for (int j = 0; j < kWarpTiles; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if ((kLive >> r) & 1u) mma_tc<T>(acc[4 * G + r][j], a[ks][j], b[r]);
  }
}

// Every group of 4 rows through the body of its live pattern (`live`
// holds the warp's row bits); a dead row issues nothing.
template <typename T, int G = 0>
__device__ __forceinline__ void groups_stage(uint32_t live, Acc& acc, const AFrags& a,
                                             uint32_t xbase, int ks0, int rb, int cb) {
  if constexpr (G < kWarpRows / 4) {
#define ZEBRA_GROUP(m) \
  case m:              \
    group_stage<T, G, m>(acc, a, xbase, ks0, rb, cb); \
    break;
    switch ((live >> (4 * G)) & 15u) {
      ZEBRA_GROUP(1) ZEBRA_GROUP(2) ZEBRA_GROUP(3) ZEBRA_GROUP(4) ZEBRA_GROUP(5)
      ZEBRA_GROUP(6) ZEBRA_GROUP(7) ZEBRA_GROUP(8) ZEBRA_GROUP(9) ZEBRA_GROUP(10)
      ZEBRA_GROUP(11) ZEBRA_GROUP(12) ZEBRA_GROUP(13) ZEBRA_GROUP(14) ZEBRA_GROUP(15)
      default: break;
    }
#undef ZEBRA_GROUP
    groups_stage<T, G + 1>(live, acc, a, xbase, ks0, rb, cb);
  }
}

// The MMAs of one stage for this warp's rows (bits of `live`) and columns.
// A stage shorter than kStageK (the last of a block when bc % kStageK !=
// 0) tests each row at each step instead; both paths give each accumulator
// the same MMAs in the same order.
template <typename T>
__device__ __forceinline__ void stage_mma(uint32_t st, uint32_t live, int len,
                                          int warp_m, int warp_n, int lane, Acc& acc) {
  // A = w^T: lanes 0-7 address k 0-7 at n 0-7, 8-15 k 0-7 at n 8-15,
  // 16-23 k 8-15 at n 0-7, 24-31 k 8-15 at n 8-15 (a0..a3)
  const int ka = (lane & 7) + ((lane >> 4) << 3);
  const int ca = (warp_n * kWarpTiles * 16 + ((lane >> 3) & 1) * 8) >> 3;
  // B = a block's 8 rows: lanes 0-7 address rows 0-7 at k 0-7, 8-15 at k 8-15
  const int rb = lane & 7, cb = (lane >> 3) & 1;
  const uint32_t xbase = st + kWBytes + warp_m * kWarpRows * kXBlock + rb * kXRow;
  AFrags a;
  if (len == kStageK) {
#pragma unroll
    for (int ks0 = 0; ks0 < kSteps; ks0 += kPartSteps) {
#pragma unroll
      for (int ks = 0; ks < kPartSteps; ++ks)
#pragma unroll
        for (int j = 0; j < kWarpTiles; ++j)
          ldmatrix_x4_trans(a[ks][j], st + w_off((ks0 + ks) * 16 + ka, ca + 2 * j));
      groups_stage<T>(live, acc, a, xbase, ks0, rb, cb);
    }
    return;
  }
  for (int ks = 0; ks * 16 < len; ++ks) {
#pragma unroll
    for (int j = 0; j < kWarpTiles; ++j)
      ldmatrix_x4_trans(a[0][j], st + w_off(ks * 16 + ka, ca + 2 * j));
#pragma unroll
    for (int r = 0; r < kWarpRows; ++r) {
      if (!((live >> r) & 1u)) continue;              // dead block: no MMA
      uint32_t b[2];
      ldmatrix_x2(b, xbase + (((2 * ks + cb) ^ rb) << 4) + r * kXBlock);
#pragma unroll
      for (int j = 0; j < kWarpTiles; ++j) mma_tc<T>(acc[r][j], a[0][j], b);
    }
  }
}

// THE 16-bit GEMM body of both kernels (see the header).
template <typename T, bool kAlignedW, typename Blocks>
__device__ __forceinline__ void mma_block_rows(
    const Blocks& blocks, const int8_t* __restrict__ bitmap,
    const T* __restrict__ w, float* __restrict__ y, int64_t nm, int64_t nk,
    int64_t N, int bs, int bc) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint32_t* live = reinterpret_cast<uint32_t*>(smem + kRingBytes);
  const uint32_t ring = smem_addr(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warp_m = warp / kWarpsN, warp_n = warp % kWarpsN;
  const int64_t i0 = (int64_t)blockIdx.x * kBlockRowsTc;
  const int64_t n0 = (int64_t)blockIdx.y * kTileNTc;

  // the CTA's keep map: bit b of live[kc] is block (i0 + b, kc)
  for (int64_t kc = threadIdx.x; kc < nk; kc += kThreadsTc) {
    uint32_t m = 0;
#pragma unroll
    for (int b = 0; b < kBlockRowsTc; ++b)
      if (i0 + b < nm && bitmap[(i0 + b) * nk + kc] != 0) m |= 1u << b;
    live[kc] = m;
  }
  __syncthreads();

  // a stage is (kc, ch): K elements kc*bc + ch*kStageK + [0, kStageK) of a
  // K-block column with a live block in the CTA, in ascending K
  const int chunks = (bc + kStageK - 1) / kStageK;
  auto next_live = [&](int kc) {
    while (kc < nk && live[kc] == 0) ++kc;
    return kc;
  };
  auto advance = [&](int& kc, int& ch) {
    if (++ch == chunks) {
      ch = 0;
      kc = next_live(kc + 1);
    }
  };
  auto issue = [&](int slot, int kc, int ch) {
    stage_load<T, kAlignedW>(ring + slot * kStageBytes, blocks, w, live[kc], i0, kc,
                          ch * kStageK, min(kStageK, bc - ch * kStageK), nk, N,
                          n0, bs, bc);
  };

  Acc acc;
#pragma unroll
  for (int bb = 0; bb < kWarpRows; ++bb)
#pragma unroll
    for (int j = 0; j < kWarpTiles; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[bb][j][q] = 0.0f;

  int load_kc = next_live(0);
  int load_ch = 0;
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (load_kc < nk) {
      issue(s, load_kc, load_ch);
      advance(load_kc, load_ch);
    }
    cp_async_commit();
  }
  int kc = next_live(0), ch = 0, slot = 0;
  while (kc < nk) {
    cp_async_wait<kStages - 2>();     // this stage has landed ...
    __syncthreads();                  // ... for every thread, and the last is consumed
    if (load_kc < nk) {
      issue((slot + kStages - 1) % kStages, load_kc, load_ch);
      advance(load_kc, load_ch);
    }
    cp_async_commit();
    const uint32_t mine = (live[kc] >> (warp_m * kWarpRows)) & ((1ull << kWarpRows) - 1);
    if (mine)
      stage_mma<T>(ring + slot * kStageBytes, mine, min(kStageK, bc - ch * kStageK),
                warp_m, warp_n, lane, acc);
    advance(kc, ch);
    slot = (slot + 1) % kStages;
  }
  cp_async_wait<0>();

  // D holds y^T: lane (g, t) has rows 2t, 2t+1 at columns g and g + 8 of
  // each 16-column tile; every output of the tile is written (+0 where
  // nothing was live)
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int bb = 0; bb < kWarpRows; ++bb) {
    const int64_t i = i0 + warp_m * kWarpRows + bb;
    if (i >= nm) break;
#pragma unroll
    for (int j = 0; j < kWarpTiles; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 2 * t + (q & 1);
        const int64_t n = n0 + warp_n * kWarpTiles * 16 + j * 16 + g + (q >> 1) * 8;
        if (r < bs && n < N) y[(i * bs + r) * N + n] = acc[bb][j][q];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The kernels: one body per dtype, the accessor the only difference
// ---------------------------------------------------------------------------

template <typename T, bool kAlignedW>
__global__ void __launch_bounds__(kThreadsOf<T>, kCtasPerSmOf<T>)
zebra_spmm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const int8_t* __restrict__ bitmap, float* __restrict__ y,
                  int64_t nm, int64_t nk, int64_t N, int bs, int bc) {
  const DenseBlocks<T> blocks{x, nk * bc, bs, bc};
  if constexpr (std::is_same<T, float>::value)
    fma_block_rows(blocks, bitmap, w, y, nm, nk, N, bs, bc);
  else
    mma_block_rows<T, kAlignedW>(blocks, bitmap, w, y, nm, nk, N, bs, bc);
}

template <typename T, bool kAlignedW>
__global__ void __launch_bounds__(kThreadsOf<T>, kCtasPerSmOf<T>)
zebra_spmm_cs_kernel(const T* __restrict__ payload,
                     const int32_t* __restrict__ slot, const T* __restrict__ w,
                     const int8_t* __restrict__ bitmap, float* __restrict__ y,
                     int64_t nm, int64_t nk, int64_t N, int bs, int bc) {
  const PayloadBlocks<T> blocks{payload, slot, bs, bc};
  if constexpr (std::is_same<T, float>::value)
    fma_block_rows(blocks, bitmap, w, y, nm, nk, N, bs, bc);
  else
    mma_block_rows<T, kAlignedW>(blocks, bitmap, w, y, nm, nk, N, bs, bc);
}

bool bad_shape(long long nm, long long nk, long long N, int bs, int bc) {
  return bs < 1 || bs > kMaxBs || bc < 1 || nm < 0 || nk < 0 || N < 0 ||
         (N + kTileN - 1) / kTileN > 65535;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// the 16-bit body's dynamic shared memory: the ring and the keep-map table
size_t tc_smem_bytes(long long nk) { return kRingBytes + 4 * nk; }

// The 16-bit launch of either kernel: checks what the tensor-core body needs
// (bc % 8 == 0, 16-byte aligned operands, the table within shared memory),
// then picks the w staging by N % 8 and launches.
template <typename Aligned, typename Ragged, typename... Args>
int launch_tc(Aligned aligned, Ragged ragged, const void* blocks, const void* w,
              long long nm, long long nk, long long N, int bc, cudaStream_t s,
              Args... args) {
  const size_t smem = tc_smem_bytes(nk);
  const bool w_rows_aligned = N % 8 == 0;
  if (bc % 8 != 0 || smem > (size_t)kMaxSmem || !aligned16(blocks) ||
      (w_rows_aligned && !aligned16(w)))
    return (int)cudaErrorInvalidValue;
  auto kernel = w_rows_aligned ? aligned : ragged;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((nm + kBlockRowsTc - 1) / kBlockRowsTc),
                  (unsigned)((N + kTileNTc - 1) / kTileNTc));
  kernel<<<grid, kThreadsTc, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

dim3 fma_grid(int64_t nm, int64_t N) {
  return dim3((unsigned)((nm + kWarps - 1) / kWarps),
              (unsigned)((N + kTileN - 1) / kTileN));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (x and w alike). y is (M, N)
// float32.
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
    zebra_spmm_kernel<float, true><<<fma_grid(nm, N), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), bm, out, nm,
        nk, N, bs, bc);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* wb = static_cast<const bf16*>(w);
    return launch_tc(zebra_spmm_kernel<bf16, true>, zebra_spmm_kernel<bf16, false>,
                     x, w, nm, nk, N, bc, s, xb, wb, bm, out, (int64_t)nm,
                     (int64_t)nk, (int64_t)N, bs, bc);
  }
  if (dtype == 2) {
    const f16* xh = static_cast<const f16*>(x);
    const f16* wh = static_cast<const f16*>(w);
    return launch_tc(zebra_spmm_kernel<f16, true>, zebra_spmm_kernel<f16, false>,
                     x, w, nm, nk, N, bc, s, xh, wh, bm, out, (int64_t)nm,
                     (int64_t)nk, (int64_t)N, bs, bc);
  }
  return (int)cudaErrorInvalidValue;
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
    zebra_spmm_cs_kernel<float, true><<<fma_grid(nm, N), kThreads, 0, s>>>(
        static_cast<const float*>(payload), sl, static_cast<const float*>(w), bm,
        out, nm, nk, N, bs, bc);
    return (int)cudaGetLastError();
  }
  if (dtype == 1) {
    const bf16* pb = static_cast<const bf16*>(payload);
    const bf16* wb = static_cast<const bf16*>(w);
    return launch_tc(zebra_spmm_cs_kernel<bf16, true>,
                     zebra_spmm_cs_kernel<bf16, false>, payload, w, nm, nk, N, bc,
                     s, pb, sl, wb, bm, out, (int64_t)nm, (int64_t)nk, (int64_t)N,
                     bs, bc);
  }
  if (dtype == 2) {
    const f16* ph = static_cast<const f16*>(payload);
    const f16* wh = static_cast<const f16*>(w);
    return launch_tc(zebra_spmm_cs_kernel<f16, true>,
                     zebra_spmm_cs_kernel<f16, false>, payload, w, nm, nk, N, bc,
                     s, ph, sl, wh, bm, out, (int64_t)nm, (int64_t)nk, (int64_t)N,
                     bs, bc);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
