// FlexVector ELL SpMM kernels for Hopper (sm_90a), plain C interface.
//
// Four entry points, each covering two TPU kernels of
// src/repro/kernels/flexvector_spmm.py: the f32/bf16/int8-exact kernel and
// its int8 _scaled variant (vtype 2, below):
//
//   fv_spmm_dense_grid   <- spmm_ell_dense_grid        (pallas_call :156, :164)
//   fv_spmm_sparse_grid  <- spmm_ell_sparse_grid       (pallas_call :271, :288)
//   fv_fused_dense_grid  <- spmm_ell_fused_dense_grid  (pallas_call :426, :437)
//   fv_fused_sparse_grid <- spmm_ell_fused_sparse_grid (pallas_call :551, :570)
//
// Storage types (vtype): 0 = f32 values with f32 dense / x / w; 1 = bf16
// values with bf16 dense / x / w; 2 = int8 values times one f32 scale per
// row block (scales[r / block_rows]) with bf16 dense / x / w; 3
// (aggregation only) = int8 values with int8 dense and no scales, the TPU
// kernels' integer path (_acc_dtype: an integer operand accumulates in
// int32).  Biases are f32.  Output (otype, aggregation only): 0 = f32, 1 =
// bf16 (each finished f32 sum rounded once, round to nearest even; the
// out_dtype=bfloat16 store), 2 = int32 (vtype 3, its only store); the
// fused kernels' output is f32.  Each C function launches on the given
// stream, does not synchronise and returns cudaGetLastError() (or
// cudaErrorInvalidValue for an argument or a type pair it does not take);
// the Python wrappers in repro_torch/kernels/flexvector_spmm.py check
// shapes, dtypes and padding, allocate the outputs and raise on a non-zero
// result.  Float sums are f32: f32 FMA on the CUDA cores (no TF32), except
// the fused layer's bf16 X W tile, which the tensor cores sum in f32; a
// bf16 or int8 operand is widened to f32 on load, an int8 value as
// float(q) * scale, so that each term is (float(q) * scale) * float(d)
// like the TPU kernels' a_blk * scale before their f32 dot.  vtype 3 uses
// no float: int8 values and int8 dense are widened to int32 and multiplied
// and added in int32 registers, so the answer is exact (|q d| <= 2^14, so
// a row overflows only past 2^17 slots).
//
// Aggregation (dense grid / sparse grid): out[r,:] = sum_t vals[r,t] *
// dense[cols[r,t],:].  The TPU kernels expand a one-hot (BR, BK) block per
// (row block, k-tile) to feed the MXU and carry the sum from one grid step
// to the next.  Here the same sum is a gather, and nothing accumulates
// across CTAs.  Bound: bytes.  The work is 2 FLOPs per gathered element,
// far below the ~20 FLOP/byte at which the f32 CUDA cores would bound it.
// The least bytes are the ELL table, each referenced dense row once and
// the (R, F) f32 output once; the sub-row output dominates at Reddit.  A
// gather reads a dense row once per slot (~103 times a row at Reddit), so
// the design keeps those re-reads out of device memory:
//   * real width: the dispatcher hands the kernel the dense operand at its
//     real width rounded up to 16 bytes (f32 to 4 columns, bf16 to 8), not
//     the planner's 128-column f-tile, so no padding column is gathered or
//     written.  The wrapper pads other callers' rows the same way.
//   * L2-resident column slabs: the columns are cut into slabs whose part
//     of the dense operand (K x slab width x storage bytes) stays within
//     L2_SLAB_BYTES, 44 MiB of the 50 MB L2 (slab_width in the Python
//     wrapper: the fewest such slabs, balanced, each a whole number of
//     16-byte pieces).  The fewest, since a narrower slab row fetches fewer
//     bytes per gather request, which measured dearer than L2 misses.  The slab is blockIdx.y and the row CTAs blockIdx.x, so the
//     CTAs in flight gather from one slab, which stays in L2 while they
//     run; each slab re-reads the ELL table (8 bytes a slot at f32).
//   * cache hints: the output is stored with st.global.cs (evict-first) and
//     the ELL table loaded with ld.global.cs, so the streams that pass
//     through L2 once (1 GB of output per Reddit layer-1 launch) do not push
//     the slab out; dense rows are loaded with ld.global.nc.  An evict-last
//     L2 policy on the dense loads (createpolicy + L2::cache_hint) measured
//     no better, so the loads take the default policy.
//   * 16-byte gathers, many in flight: a group of lanes spans one slab
//     row, a lane per 16-byte piece (4 f32, 8 bf16 or 16 int8 columns; 8
//     lanes for a 128-byte slab, fewer for a narrower one, up to 32 and
//     then a loop),
//     so a warp works on several rows at once.  Each lane decodes its row's
//     slots itself (the group's lanes load the same words, one transaction;
//     two slots a load when tau is even) and issues every gather of up to
//     kAggBatch slots before its FMAs; a longer row takes further batches.
//     The sparse grid's bitmap test runs beside the gathers and drops only
//     the FMA of an unlisted slot.  Groups need no warp collectives, so a
//     group may straddle warps and a CTA may hold any count of them; the
//     registers are capped for four CTAs (32 warps) per SM, three for the
//     int32 instantiation, whose lane keeps 16 int32 sums (a 16-column int8
//     piece) beside its 8 gathered pieces.
//   * stores: a piece's sums leave as 16-byte vectors (one float4 per 4
//     f32 columns, one uint4 per 8 bf16 or 4 int32), or one 8-byte uint2
//     for the 4 bf16 columns of an f32 piece.
// Each CTA holds rows of one row block (for its int8 scale and its
// schedule bitmap).  Order of sums: each output element adds its slots'
// products in slot order, one fmaf each, starting from +0, at every
// precision; only FMA contraction differs from the plain version.  A bf16
// or int8 value is widened and scaled first ((float(q) * scale) * d).  The
// int32 sums are exact in any order.

// The sparse grid honours its schedule.  The TPU kernel takes the (rb_ids,
// kb_ids, first) steps of plan_kernel_grid; the schedule is a per-graph
// constant, so the host turns it once per graph into one k-tile bitmap per
// row block (each row block's run of steps: a run starts at a step with
// first = 1 and lasts until the next, and a row block takes the run of its
// last first step, as the TPU kernel's output would).  A CTA copies its row
// block's bitmap into shared memory and counts an ELL slot only if its
// k-tile is listed.  No work is spent on the schedule at launch time.
//
// Fused layer (dense grid / sparse grid): out = A . (X W + b) with rows
// >= k_real of X W + b taken as zero, X W + b never written to device
// memory.  The TPU kernel keeps the whole (R, BF) output slab in VMEM
// across its k sweep; a CTA's shared memory holds about 450 f32 rows of
// it, so the order of sums is turned around.  One CTA per (chunk of a
// 64-row column group's slots, 128 output columns) forms that group's
// (64, 128) tile of X W + b once in shared memory and scatters it through
// the ELL slots whose column lies in its 64 rows, adding v * XW[c] into a
// zeroed f32 output with atomics (they take the place of the TPU's
// resident output slab).  The slot lists are the ELL table transposed by
// column group, built once per graph on the host (column_slots in the
// Python wrapper); a group holding more than 4x the mean is cut into
// chunks, one per CTA, each recomputing the tile, so that a hub column's
// group (437 K of Reddit's 24 M slots, against a mean of 6.6 K) does not
// leave one CTA walking it while the card idles.  The sparse variant
// loads kb_ids (-1 = no-op step) into a shared-memory bitmap, skips a
// group none of whose k-tiles is listed and counts only listed slots.
//
// One kernel for every storage type, templated over the values (and so
// the type of x / w):
//   * the tile: X and W stream through a three-stage ring of 32-deep
//     chunks in shared memory with cp.async (16-byte copies, zero-filled
//     past the edges; rows padded by 16 bytes), so the next chunks load
//     while this one is multiplied.  bf16 x / w (bf16 and int8 values):
//     mma.sync m16n8k16 bf16 products with f32 accumulation on the tensor
//     cores, fed by ldmatrix (eight warps, each a 32 x 32 sub-tile).  bf16
//     x bf16 products are exact in f32, so only the order of the f32 sums
//     differs from a library matmul.  f32 x / w: f32 FMA on the CUDA cores
//     (each thread an 8 x 4 register tile), since TF32 would round the
//     inputs to 10 bits (about 7e-4 of the output scale over 500-602
//     terms).  The epilogue adds b, zeroes rows >= k_real and, for bf16 x
//     / w, rounds to bf16 (the TPU kernel's cast_xw); the f32 tile is kept
//     as it is.
//   * the scatter: each lane decodes one slot of the chunk (32 per warp at
//     a time); walkers of 8, 16 or 32 lanes, a lane per 4 columns, then
//     walk the slots one by one.  A walker spans only the tile's live
//     columns (up to its last nonzero one: 64 of 128 at a 64-wide layer,
//     41 at Reddit's output layer), so a warp walks 1, 2 or 4 slots at a
//     time.  Slots are in flat order, so the slots of one output row are
//     consecutive: their terms are summed in registers and the row takes
//     one 16-byte vector reduction per lane.  A lane whose four sums are
//     zero adds nothing, exactly: out starts at +0.
// Cost: 2 K F_in F_out FLOPs (the unfused combination's count; a group
// with no slot, or no listed k-tile, is skipped; each extra chunk of a hub
// group adds one tile) plus the scatter: one read-modify-write of the
// touched part of an output row for each run of a row's slots in a group.
// At GCN widths the scatter bounds it (the output is far larger than the
// L2 at Reddit, so each run reads and writes its lines in device memory).
// Order of sums: the tile's f32 sums run in another order than a library
// matmul (under bf16 an element near a rounding boundary can round the
// other way, one bf16 ulp), and the atomics add the terms of an output row
// in run-dependent order, at every precision.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Aggregation: ELL slots whose gathers a lane issues before their FMAs,
// and the widest lane group (one 16-byte piece of a slab row a lane).
constexpr int kAggBatch = 8;
constexpr int kMaxGroup = 32;
// Aggregation CTAs resident per SM: caps the registers at 64 a thread so
// that 32 warps keep their gathers in flight (bf16 and int8 would take 72).
// The int32 instantiation's 16 sums a lane take it to three (80
// registers).
constexpr int kAggBlocksPerSM = 4;
constexpr int kAggBlocksPerSMInt = 3;

constexpr int kDefaultSmemLimit = 48 * 1024;

// Fused tiling: a CTA forms kXwRows rows of X W + b (XW_TILE_ROWS in the
// Python wrapper) x kXwCols output columns, streaming F_in through a ring
// of kStages chunks kXwDepth deep.  The f32 product gives thread (warp ty,
// lane tx) rows ty + 8 i and columns tx + 32 q of the tile.
constexpr int kXwRows = 64;
constexpr int kXwCols = 128;
constexpr int kXwDepth = 32;
constexpr int kStages = 3;
constexpr int kRowsPerThread = kXwRows / kWarps;  // 8
constexpr int kColsPerThread = kXwCols / 32;      // 4

constexpr unsigned kFullMask = 0xffffffffu;

// Storage types of the C interface: values (with their dense operand) and
// the aggregation's output.
enum VType { kF32 = 0, kBF16 = 1, kI8 = 2, kI8Exact = 3 };
enum OType { kOutF32 = 0, kOutBF16 = 1, kOutI32 = 2 };

// The fused kernels' x / w beside values of type V.
template <typename V>
using Dense = typename std::conditional<std::is_same<V, float>::value, float,
                                        __nv_bfloat16>::type;

// The aggregation's sums beside output type O: int32 for the int32 store,
// else f32.
template <typename O>
using Acc = typename std::conditional<std::is_same<O, int>::value, int,
                                      float>::type;
template <typename O>
constexpr int kAggBlocks =
    std::is_same<O, int>::value ? kAggBlocksPerSMInt : kAggBlocksPerSM;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

__device__ __forceinline__ bool tile_listed(const unsigned* bitmap, int kb) {
  return (bitmap[kb >> 5] >> (kb & 31)) & 1u;
}

__device__ __forceinline__ void zero_bitmap(unsigned* bitmap, int words) {
  for (int i = threadIdx.x; i < words; i += kThreads) bitmap[i] = 0u;
}

// ---------------------------------------------------------------------------
// Aggregation: dense grid (kSched = false) and sparse grid (kSched = true)
// ---------------------------------------------------------------------------

// 16 bytes of the dense operand: four f32, eight bf16 or 16 int8 columns.
template <typename T>
struct Piece {
  static constexpr int kCols = 16 / (int)sizeof(T);
};

// ELL loads: cache-streaming (evict-first), read once per slab.
template <typename T>
__device__ __forceinline__ T ell_load(const T* p) {
  return __ldcs(p);
}

// One ELL value, widened to the sums' type (int8 to int32 only beside the
// int32 store).
__device__ __forceinline__ void load_val(const float* p, float& v) {
  v = ell_load(p);
}
__device__ __forceinline__ void load_val(const __nv_bfloat16* p, float& v) {
  v = __bfloat162float(__ushort_as_bfloat16(
      ell_load(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ void load_val(const int8_t* p, float& v) {
  v = (float)ell_load(reinterpret_cast<const signed char*>(p));
}
__device__ __forceinline__ void load_val(const int8_t* p, int& v) {
  v = (int)ell_load(reinterpret_cast<const signed char*>(p));
}

// Two consecutive values of an ELL row (8-, 4- or 2-byte aligned).
__device__ __forceinline__ void load_val2(const float* p, float& a,
                                          float& b) {
  const float2 v = ell_load(reinterpret_cast<const float2*>(p));
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void load_val2(const __nv_bfloat16* p, float& a,
                                          float& b) {
  const unsigned w = ell_load(reinterpret_cast<const unsigned*>(p));
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void load_val2(const int8_t* p, float& a,
                                          float& b) {
  const char2 q = ell_load(reinterpret_cast<const char2*>(p));
  a = (float)(signed char)q.x;
  b = (float)(signed char)q.y;
}
__device__ __forceinline__ void load_val2(const int8_t* p, int& a, int& b) {
  const char2 q = ell_load(reinterpret_cast<const char2*>(p));
  a = (int)(signed char)q.x;
  b = (int)(signed char)q.y;
}

// One 16-byte piece of a dense row, through the read-only path.
__device__ __forceinline__ uint4 load_piece(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// acc[e] += v * piece[e], e over the piece's 4 (f32) or 8 (bf16) columns.
__device__ __forceinline__ void fma_piece(float* acc, float v, uint4 d,
                                          const float*) {
  acc[0] = fmaf(v, __uint_as_float(d.x), acc[0]);
  acc[1] = fmaf(v, __uint_as_float(d.y), acc[1]);
  acc[2] = fmaf(v, __uint_as_float(d.z), acc[2]);
  acc[3] = fmaf(v, __uint_as_float(d.w), acc[3]);
}
__device__ __forceinline__ void fma_piece(float* acc, float v, uint4 d,
                                          const __nv_bfloat16*) {
  // a bf16 is the top half of an f32: widen each pair with a shift / mask
  acc[0] = fmaf(v, __uint_as_float(d.x << 16), acc[0]);
  acc[1] = fmaf(v, __uint_as_float(d.x & 0xffff0000u), acc[1]);
  acc[2] = fmaf(v, __uint_as_float(d.y << 16), acc[2]);
  acc[3] = fmaf(v, __uint_as_float(d.y & 0xffff0000u), acc[3]);
  acc[4] = fmaf(v, __uint_as_float(d.z << 16), acc[4]);
  acc[5] = fmaf(v, __uint_as_float(d.z & 0xffff0000u), acc[5]);
  acc[6] = fmaf(v, __uint_as_float(d.w << 16), acc[6]);
  acc[7] = fmaf(v, __uint_as_float(d.w & 0xffff0000u), acc[7]);
}
// acc[e] += v * piece[e] over 16 int8 columns, in int32: each byte is
// sign-extended in place (one bit-field extract), no float.
__device__ __forceinline__ void fma_piece(int* acc, int v, uint4 d,
                                          const int8_t*) {
  const unsigned w[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      acc[4 * i + b] += v * (int)(signed char)(w[i] >> (8 * b));
}

// A piece's kCols sums to the output row at o, cache-streaming
// (evict-first): f32 as float4s, bf16 rounded (nearest even) and packed two
// to a word, int32 as int4s.
template <int kCols>
__device__ __forceinline__ void store_piece(float* o, const float* acc) {
#pragma unroll
  for (int q = 0; q < kCols / 4; ++q)
    __stcs(reinterpret_cast<float4*>(o) + q,
           make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                       acc[4 * q + 3]));
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}
template <int kCols>
__device__ __forceinline__ void store_piece(__nv_bfloat16* o,
                                            const float* acc) {
  static_assert(kCols == 4 || kCols == 8, "a bf16 store of f32 sums");
  if constexpr (kCols == 4) {
    __stcs(reinterpret_cast<uint2*>(o),
           make_uint2(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3])));
  } else {
    __stcs(reinterpret_cast<uint4*>(o),
           make_uint4(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]),
                      pack_bf16(acc[4], acc[5]), pack_bf16(acc[6], acc[7])));
  }
}
template <int kCols>
__device__ __forceinline__ void store_piece(int* o, const int* acc) {
#pragma unroll
  for (int q = 0; q < kCols / 4; ++q)
    __stcs(reinterpret_cast<int4*>(o) + q,
           make_int4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                     acc[4 * q + 3]));
}

// Rows per aggregation CTA, all inside one row block: one per lane group,
// or the whole row block when the groups do not divide it.
__host__ __device__ int agg_rows_per_cta(int block_rows, int groups) {
  return block_rows % groups == 0 ? groups : block_rows;
}

// One CTA: n_rows rows of one row block x one column slab (blockIdx.y,
// slab_cols wide, the last one narrower).  Lane group gi (`group` lanes,
// blockDim.x / group groups) takes rows gi, gi + groups, ...; lane gl of
// it pieces gl, gl + group, ... of the slab row.  V: the values, D: the
// dense operand, O: the output.
template <typename V, typename D, typename O, bool kSched>
__global__ void __launch_bounds__(kThreads, kAggBlocks<O>)
    ell_aggregate_kernel(
    const int* __restrict__ cols, const V* __restrict__ vals,
    const float* __restrict__ scales, const D* __restrict__ dense,
    O* __restrict__ out, int tau, int K, int F, int slab_cols, int group,
    int n_rows, int block_rows, int block_k, int kb_shift, bool pairs,
    const unsigned* __restrict__ tile_bitmaps, int n_kb) {
  using A = Acc<O>;
  constexpr int kCols = Piece<D>::kCols;
  extern __shared__ unsigned bitmap[];
  const int64_t r0 = (int64_t)blockIdx.x * n_rows;
  const int rb = (int)(r0 / block_rows);
  const int c0 = blockIdx.y * slab_cols;
  const int pieces = min(slab_cols, F - c0) / kCols;

  if (kSched) {
    const int words = (n_kb + 31) >> 5;
    const unsigned* src = tile_bitmaps + (int64_t)rb * words;
    for (int i = threadIdx.x; i < words; i += blockDim.x) bitmap[i] = src[i];
    __syncthreads();
  }
  const int groups = blockDim.x / group;
  const int gi = threadIdx.x / group;
  const int gl = threadIdx.x - gi * group;
  if (gi >= groups) return;  // threads past the last whole group
  const float scale = scales != nullptr ? scales[rb] : 1.f;

  for (int lr = gi; lr < n_rows; lr += groups) {
    const int64_t r = r0 + lr;
    const int* crow = cols + r * tau;
    const V* vrow = vals + r * tau;
    for (int p = gl; p < pieces; p += group) {
      const D* dcol = dense + c0 + p * kCols;
      A acc[kCols];
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[e] = 0;
      for (int t0 = 0; t0 < tau; t0 += kAggBatch) {
        // decode: each lane of the group reads the same slots
        int c[kAggBatch];
        A v[kAggBatch];
#pragma unroll
        for (int j = 0; j < kAggBatch; ++j) {
          c[j] = -1;
          v[j] = 0;
        }
        if (pairs) {  // tau even: slot pairs in one load each
#pragma unroll
          for (int j = 0; j < kAggBatch; j += 2)
            if (t0 + j < tau) {
              const int2 cc =
                  ell_load(reinterpret_cast<const int2*>(crow + t0 + j));
              load_val2(vrow + t0 + j, v[j], v[j + 1]);
              c[j] = cc.x;
              c[j + 1] = cc.y;
            }
        } else {
#pragma unroll
          for (int j = 0; j < kAggBatch; ++j)
            if (t0 + j < tau) {
              c[j] = ell_load(crow + t0 + j);
              load_val(vrow + t0 + j, v[j]);
            }
        }
        // every gather of the batch before its FMAs; the sparse grid's
        // bitmap test runs beside the gathers and drops only the FMA
        uint4 d[kAggBatch];
#pragma unroll
        for (int j = 0; j < kAggBatch; ++j) {
          if (c[j] >= K) c[j] = -1;
          d[j] = c[j] >= 0 ? load_piece(dcol + (int64_t)c[j] * F)
                           : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int j = 0; j < kAggBatch; ++j) {
          bool keep = c[j] >= 0;
          if (kSched && keep)
            keep = tile_listed(bitmap, kb_shift >= 0 ? c[j] >> kb_shift
                                                     : c[j] / block_k);
          if constexpr (!std::is_same<V, float>::value &&
                        std::is_same<A, float>::value)
            v[j] *= scale;
          if (keep) fma_piece(acc, v[j], d[j], dcol);
        }
      }
      store_piece<kCols>(out + r * F + c0 + p * kCols, acc);
    }
  }
}

// ---------------------------------------------------------------------------
// Fused layer: dense grid (kSched = false) and sparse grid (kSched = true),
// one kernel for f32, bf16 and int8 values
// ---------------------------------------------------------------------------

// Shared memory of the fused kernel for x / w of type T: the ring of
// kStages (X chunk, W chunk) pairs, which the (kXwRows, kXwCols) tile of
// X W + b reuses once the product is done.  Rows are padded by 16 bytes so
// that ldmatrix's eight row addresses fall in distinct banks.
template <typename T>
struct FusedSmem {
  static constexpr int kVec = 16 / (int)sizeof(T);  // elements per copy
  static constexpr int kXPitch = kXwDepth + kVec;
  static constexpr int kWPitch = kXwCols + kVec;
  static constexpr int kTilePitch = kXwCols + kVec;
  static constexpr int kStageElems = kXwRows * kXPitch + kXwDepth * kWPitch;
  static constexpr int kRingBytes = kStages * kStageElems * (int)sizeof(T);
  static constexpr int kTileBytes = kXwRows * kTilePitch * (int)sizeof(T);
  static constexpr int kBytes =
      kRingBytes > kTileBytes ? kRingBytes : kTileBytes;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy of the first `bytes` (0-16) of src to dst; the
// rest of dst is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's copy groups are in flight.
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// Chunk k0 of X (rows row0.., kXwDepth columns) and of W (kXwDepth rows,
// columns n0..) into one stage of the ring.  Rows of x are F_in long and
// rows of w ldw long, both 16-byte aligned (the wrapper sees to it).
template <typename T>
__device__ __forceinline__ void load_chunk(T* xs, T* ws,
                                           const T* __restrict__ x,
                                           const T* __restrict__ w, int row0,
                                           int K, int F_in, int n0, int F_out,
                                           int ldw, int k0) {
  using S = FusedSmem<T>;
  constexpr int kXSegs = kXwDepth / S::kVec;  // 16-byte copies per X row
  constexpr int kWSegs = kXwCols / S::kVec;   // per W row
  static_assert(kXwRows * kXSegs % kThreads == 0 &&
                    kXwDepth * kWSegs % kThreads == 0,
                "every thread makes the same number of copies");
#pragma unroll
  for (int it = 0; it < kXwRows * kXSegs / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int rr = i / kXSegs;
    const int j = (i % kXSegs) * S::kVec;
    const int row = row0 + rr;
    const int kk = k0 + j;
    const bool in = row < K && kk < F_in;
    cp_async16(xs + rr * S::kXPitch + j,
               in ? x + (int64_t)row * F_in + kk : x,
               in ? min(S::kVec, F_in - kk) * (int)sizeof(T) : 0);
  }
#pragma unroll
  for (int it = 0; it < kXwDepth * kWSegs / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int j = i / kWSegs;
    const int n = (i % kWSegs) * S::kVec;
    const int kj = k0 + j;
    const int col = n0 + n;
    const bool in = kj < F_in && col < F_out;
    cp_async16(ws + j * S::kWPitch + n,
               in ? w + (int64_t)kj * ldw + col : w,
               in ? min(S::kVec, F_out - col) * (int)sizeof(T) : 0);
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stream F_in through the ring: chunk kc + kStages - 1 is loading while
// mul(xs, ws) multiplies chunk kc.  Ends with every copy landed and a
// barrier, so the ring is free for the tile.
template <typename T, typename Mul>
__device__ __forceinline__ void stream_chunks(T* smem, const T* __restrict__ x,
                                              const T* __restrict__ w,
                                              int row0, int K, int F_in,
                                              int n0, int F_out, int ldw,
                                              Mul mul) {
  using S = FusedSmem<T>;
  const int n_k = (F_in + kXwDepth - 1) / kXwDepth;
  auto load = [&](int kc) {
    T* st = smem + (kc % kStages) * S::kStageElems;
    load_chunk(st, st + kXwRows * S::kXPitch, x, w, row0, K, F_in, n0, F_out,
               ldw, kc * kXwDepth);
  };
#pragma unroll
  for (int kc = 0; kc < kStages - 1; ++kc) {
    if (kc < n_k) load(kc);
    cp_async_commit();  // one group per chunk, empty past the end
  }
  for (int kc = 0; kc < n_k; ++kc) {
    cp_async_wait<kStages - 2>();  // chunk kc has landed
    __syncthreads();               // ... for every thread; kc - 1 is free
    if (kc + kStages - 1 < n_k) load(kc + kStages - 1);
    cp_async_commit();
    const T* xs = smem + (kc % kStages) * S::kStageElems;
    mul(xs, xs + kXwRows * S::kXPitch);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The tile of X W + b into shared memory: the product through the ring,
// then + b, rows >= k_real and columns >= F_out zeroed, stored as T (bf16:
// rounded).  Ends with a barrier: the tile is ready for every thread.
//
// bf16: warp (wm, wn) = (warp % 2, warp / 2) owns rows 32 wm.. and columns
// 32 wn.. of the tile: two m16 x four n8 mma tiles per 16-deep step.
__device__ __forceinline__ void form_tile(
    __nv_bfloat16* smem, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ b,
    int row0, int n0, int K, int F_in, int F_out, int ldw, int k_real) {
  using T = __nv_bfloat16;
  using S = FusedSmem<T>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 1;
  const int wn = warp >> 1;
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  stream_chunks(smem, x, w, row0, K, F_in, n0, F_out, ldw,
                [&](const T* xs, const T* ws) {
#pragma unroll
    for (int kk = 0; kk < kXwDepth; kk += 16) {
      unsigned a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldmatrix_x4(a[mt], xs + (32 * wm + 16 * mt + (lane & 15)) * S::kXPitch +
                               kk + (lane >> 4) * 8);
      unsigned bq[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4_trans(bq[np], ws + (kk + (lane & 15)) * S::kWPitch +
                                      32 * wn + 16 * np + (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16(acc[mt][nt], a[mt], bq[nt >> 1][2 * (nt & 1)],
                   bq[nt >> 1][2 * (nt & 1) + 1]);
    }
  });

  const int g = lane >> 2;
  const int tg = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lr = 32 * wm + 16 * mt + g + 8 * h;
        const int lc = 32 * wn + 8 * nt + 2 * tg;
        const bool row_in = row0 + lr < k_real;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + lc + e;
          v[e] = (row_in && col < F_out) ? acc[mt][nt][2 * h + e] + b[col]
                                         : 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(smem + lr * S::kTilePitch + lc) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
  __syncthreads();
}

// f32: f32 FMA on the CUDA cores, thread (warp ty, lane tx) owning rows
// ty + 8 i and columns tx + 32 q; X is read four columns at a time.
__device__ __forceinline__ void form_tile(
    float* smem, const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ b, int row0, int n0, int K, int F_in,
    int F_out, int ldw, int k_real) {
  using S = FusedSmem<float>;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) acc[i][q] = 0.f;

  stream_chunks(smem, x, w, row0, K, F_in, n0, F_out, ldw,
                [&](const float* xs, const float* ws) {
#pragma unroll 2
    for (int j = 0; j < kXwDepth; j += 4) {
      float4 a[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            xs + (ty + kWarps * i) * S::kXPitch + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float bw[kColsPerThread];
#pragma unroll
        for (int q = 0; q < kColsPerThread; ++q)
          bw[q] = ws[(j + jj) * S::kWPitch + tx + 32 * q];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const float av = jj == 0 ? a[i].x : jj == 1 ? a[i].y
                         : jj == 2 ? a[i].z : a[i].w;
#pragma unroll
          for (int q = 0; q < kColsPerThread; ++q)
            acc[i][q] = fmaf(av, bw[q], acc[i][q]);
        }
      }
    }
  });

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int lr = ty + kWarps * i;
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) {
      const int col = n0 + tx + 32 * q;
      smem[lr * S::kTilePitch + tx + 32 * q] =
          (row0 + lr < k_real && col < F_out) ? acc[i][q] + b[col] : 0.f;
    }
  }
  __syncthreads();
}

// Four consecutive tile elements as f32.
__device__ __forceinline__ float4 tile_quad(const float* t) {
  return *reinterpret_cast<const float4*>(t);
}
__device__ __forceinline__ float4 tile_quad(const __nv_bfloat16* t) {
  const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(t);
  const float2 lo = __bfloat1622float2(pair[0]);
  const float2 hi = __bfloat1622float2(pair[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename V, bool kSched>
__global__ void __launch_bounds__(kThreads, 2) ell_fused_xw_kernel(
    const int* __restrict__ cols, const V* __restrict__ vals,
    const float* __restrict__ scales, const Dense<V>* __restrict__ x,
    const Dense<V>* __restrict__ w, const float* __restrict__ b,
    float* __restrict__ out, const int* __restrict__ slot_group,
    const int* __restrict__ slot_start, const int* __restrict__ slot_ids,
    int tau, int K, int F_in, int F_out, int ldw, int k_real, int block_rows,
    int block_k, const int* __restrict__ kb_ids, int n_steps, int n_kb,
    bool vec) {
  using T = Dense<V>;
  using S = FusedSmem<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);  // the ring, then the tile
  unsigned* bitmap = reinterpret_cast<unsigned*>(smem_raw + S::kBytes);
  __shared__ int any_listed;
  __shared__ int live_cols;

  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  // blockIdx.x is a chunk of one column group's slots (column_slots)
  const int row0 = slot_group[blockIdx.x] * kXwRows;
  const int n0 = blockIdx.y * kXwCols;
  const int s_begin = slot_start[blockIdx.x];
  const int s_end = slot_start[blockIdx.x + 1];
  if (s_begin == s_end || row0 >= k_real) return;  // adds nothing

  if (kSched) {
    zero_bitmap(bitmap, (n_kb + 31) >> 5);
    __syncthreads();
    for (int s = threadIdx.x; s < n_steps; s += kThreads) {
      const int kb = kb_ids[s];
      if (kb >= 0 && kb < n_kb) atomicOr(&bitmap[kb >> 5], 1u << (kb & 31));
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int found = 0;
      const int last = min(row0 + kXwRows, K) - 1;
      for (int kb = row0 / block_k; kb <= last / block_k; ++kb)
        found |= (int)tile_listed(bitmap, kb);
      any_listed = found;
    }
    __syncthreads();
    if (!any_listed) return;  // none of the group's k-tiles is scheduled
  }

  if (threadIdx.x == 0) live_cols = 0;
  form_tile(smem, x, w, b, row0, n0, K, F_in, F_out, ldw, k_real);
  const T* tile = smem;

  // The tile's live columns: 1 + the last column holding a nonzero value.
  {
    const int c = threadIdx.x % kXwCols;
    bool nz = false;
    for (int rr = threadIdx.x / kXwCols; rr < kXwRows;
         rr += kThreads / kXwCols)
      nz |= to_f32(tile[rr * S::kTilePitch + c]) != 0.f;
    if (nz) atomicMax(&live_cols, c + 1);
  }
  __syncthreads();
  if (live_cols == 0) return;  // every term is zero: nothing to add

  // The scatter.  A walker of `lanes` lanes (a lane per 4 columns) covers
  // the live columns: a whole warp for more than 64, a half-warp for
  // 33-64, a quarter for 1-32, so that a warp walks 1, 2 or 4 slots at a
  // time.  Each lane decodes one slot of the chunk (32 per warp at a
  // time), and walker `wk` takes slots lanes * wk.. of the 32.  Slots are
  // in flat order, so the slots of one output row are consecutive: their
  // terms are summed in registers and the row takes one add per lane at
  // the end of its run (one 16-byte vector reduction, REDG.ADD.F32x4, when
  // `vec`: F_out a multiple of 4 and out 16-byte aligned).  Columns past
  // the live ones hold exact zeros and a lane whose four sums are zero
  // adds nothing: out starts at +0, and x + 0 is x for every x but -0,
  // which a sum from +0 never reaches.
  const int lanes = live_cols <= 32 ? 8 : live_cols <= 64 ? 16 : 32;
  const int wk = tx / lanes;
  const int cl = 4 * (tx % lanes);  // the lane's first column in the tile
  const int col = n0 + cl;
  for (int base = s_begin + ty * 32; base < s_end; base += kWarps * 32) {
    const int s = base + tx;
    int c_own = -1;  // column in the tile, -1: the slot adds nothing
    int r_own = -1;
    float v_own = 0.f;
    if (s < s_end) {
      const int idx = slot_ids[s];
      const int c = cols[idx];
      bool keep = c >= row0 && c < row0 + kXwRows && c < k_real;
      if (kSched && keep) keep = tile_listed(bitmap, c / block_k);
      if (keep) {
        r_own = idx / tau;
        c_own = c - row0;
        v_own = to_f32(vals[idx]);
        if (scales != nullptr) v_own *= scales[r_own / block_rows];
      }
    }
    // the slot ends its row's run: the next slot (of the same walker) has
    // another row
    const int r_after = __shfl_down_sync(kFullMask, r_own, 1);
    const bool ends = (tx % lanes) == lanes - 1 || r_after != r_own;
    const int meta = c_own < 0 ? -1 : c_own | (int)ends << 6;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < lanes; ++j) {
      const int src = wk * lanes + j;
      const int m = __shfl_sync(kFullMask, meta, src);
      const float v = __shfl_sync(kFullMask, v_own, src);
      const int r = __shfl_sync(kFullMask, r_own, src);
      if (m < 0) continue;  // uniform across the walker
      const float4 t = tile_quad(tile + (m & 63) * S::kTilePitch + cl);
      acc.x = fmaf(v, t.x, acc.x);
      acc.y = fmaf(v, t.y, acc.y);
      acc.z = fmaf(v, t.z, acc.z);
      acc.w = fmaf(v, t.w, acc.w);
      if (!(m >> 6)) continue;  // the row goes on
      if (acc.x != 0.f || acc.y != 0.f || acc.z != 0.f || acc.w != 0.f) {
        float* orow = out + (int64_t)r * F_out + col;
        if (vec) {
          if (col < F_out) atomicAdd(reinterpret_cast<float4*>(orow), acc);
        } else {
          const float part[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < F_out) atomicAdd(orow + e, part[e]);
        }
      }
      acc = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

int bitmap_bytes(int n_kb) { return ((n_kb + 31) / 32) * (int)sizeof(unsigned); }

// Raise a kernel's dynamic shared-memory cap when static + dynamic use
// passes the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int static_bytes, int dyn_bytes) {
  if (static_bytes + dyn_bytes <= kDefaultSmemLimit) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn_bytes);
}

template <typename V, typename D, typename O, bool kSched>
int launch_aggregate(const int* cols, const void* vals, const float* scales,
                     const void* dense, void* out,
                     const unsigned* tile_bitmaps, int R, int tau, int K,
                     int F, int block_rows, int block_k, int slab_cols,
                     cudaStream_t stream) {
  constexpr int kCols = Piece<D>::kCols;
  // 16-byte pieces: rows, slabs and both pointers on 16-byte boundaries
  if (F % kCols != 0 || slab_cols <= 0 || slab_cols % kCols != 0 ||
      R % block_rows != 0 ||
      (reinterpret_cast<uintptr_t>(dense) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int n_kb = kSched ? K / block_k : 0;
  const int dyn = kSched ? bitmap_bytes(n_kb) : 0;
  cudaError_t e = allow_smem(ell_aggregate_kernel<V, D, O, kSched>, 0, dyn);
  if (e != cudaSuccess) return (int)e;
  const int group = slab_cols / kCols < kMaxGroup ? slab_cols / kCols
                                                  : kMaxGroup;
  const int n_rows = agg_rows_per_cta(block_rows, kThreads / group);
  // fewer threads when one row block holds fewer rows than the groups
  const int wanted = (group * n_rows + 31) / 32 * 32;
  const int threads = wanted < kThreads ? wanted : kThreads;
  // k-tile of a column by a shift when block_k is a power of two
  int kb_shift = -1;
  for (int b = 0; b < 31; ++b)
    if (block_k == (1 << b)) kb_shift = b;
  // slot pairs in one load when they lie on the pair's boundary
  const bool pairs = tau % 2 == 0 &&
                     (reinterpret_cast<uintptr_t>(cols) & 7) == 0 &&
                     (reinterpret_cast<uintptr_t>(vals) &
                      (2 * sizeof(V) - 1)) == 0;
  dim3 grid(R / n_rows, (F + slab_cols - 1) / slab_cols);
  ell_aggregate_kernel<V, D, O, kSched><<<grid, threads, dyn, stream>>>(
      cols, static_cast<const V*>(vals), scales, static_cast<const D*>(dense),
      static_cast<O*>(out), tau, K, F, slab_cols, group, n_rows, block_rows,
      block_k, kb_shift, pairs, tile_bitmaps, n_kb);
  return (int)cudaGetLastError();
}

constexpr int type_pair(int vtype, int otype) { return vtype * 3 + otype; }

// The instantiation for (vtype, otype), launched.
template <bool kSched>
int aggregate(int vtype, int otype, const int* cols, const void* vals,
              const float* scales, const void* dense, void* out,
              const unsigned* tile_bitmaps, int R, int tau, int K, int F,
              int block_rows, int block_k, int slab_cols,
              cudaStream_t stream) {
  // scales go with int8 values beside a bf16 operand and only with them
  if ((vtype == kI8) != (scales != nullptr)) return (int)cudaErrorInvalidValue;
  const auto run = [&](auto launch) {
    return launch(cols, vals, scales, dense, out, tile_bitmaps, R, tau, K, F,
                  block_rows, block_k, slab_cols, stream);
  };
  using BF = __nv_bfloat16;
  switch (type_pair(vtype, otype)) {
    case type_pair(kF32, kOutF32):
      return run(launch_aggregate<float, float, float, kSched>);
    case type_pair(kF32, kOutBF16):
      return run(launch_aggregate<float, float, BF, kSched>);
    case type_pair(kBF16, kOutF32):
      return run(launch_aggregate<BF, BF, float, kSched>);
    case type_pair(kBF16, kOutBF16):
      return run(launch_aggregate<BF, BF, BF, kSched>);
    case type_pair(kI8, kOutF32):
      return run(launch_aggregate<int8_t, BF, float, kSched>);
    case type_pair(kI8, kOutBF16):
      return run(launch_aggregate<int8_t, BF, BF, kSched>);
    case type_pair(kI8Exact, kOutI32):
      return run(launch_aggregate<int8_t, int8_t, int, kSched>);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename V, bool kSched>
int launch_fused_xw(const int* cols, const void* vals, const float* scales,
                    const void* x, const void* w, const float* b, float* out,
                    const int* slot_group, const int* slot_start,
                    const int* slot_ids, int n_chunks, int tau, int K,
                    int F_in, int F_out, int ldw, int k_real, int block_rows,
                    int block_k, const int* kb_ids, int n_steps,
                    cudaStream_t stream) {
  using T = Dense<V>;
  constexpr int kVec = FusedSmem<T>::kVec;
  // cp.async copies 16 aligned bytes: rows of x and w must start on them
  if (F_in % kVec != 0 || ldw % kVec != 0 || ldw < F_out ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(w) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return (int)cudaSuccess;  // no slot: out stays zero
  const int n_kb = K / block_k;
  const int dyn = FusedSmem<T>::kBytes + (kSched ? bitmap_bytes(n_kb) : 0);
  cudaError_t e =
      allow_smem(ell_fused_xw_kernel<V, kSched>, 2 * (int)sizeof(int), dyn);
  if (e != cudaSuccess) return (int)e;
  const bool vec = (F_out & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  dim3 grid(n_chunks, (F_out + kXwCols - 1) / kXwCols);
  ell_fused_xw_kernel<V, kSched><<<grid, kThreads, dyn, stream>>>(
      cols, static_cast<const V*>(vals), scales, static_cast<const T*>(x),
      static_cast<const T*>(w), b, out, slot_group, slot_start, slot_ids, tau,
      K, F_in, F_out, ldw, k_real, block_rows, block_k, kb_ids, n_steps, n_kb,
      vec);
  return (int)cudaGetLastError();
}

template <bool kSched>
int fused(int vtype, const int* cols, const void* vals, const float* scales,
          const void* x, const void* w, const float* b, float* out,
          const int* slot_group, const int* slot_start, const int* slot_ids,
          int n_chunks, const int* kb_ids, int n_steps, int tau, int K,
          int F_in, int F_out, int ldw, int k_real, int block_rows,
          int block_k, cudaStream_t stream) {
  if ((vtype == kI8) != (scales != nullptr)) return (int)cudaErrorInvalidValue;
  if (n_chunks > 0 && (slot_group == nullptr || slot_start == nullptr ||
                       slot_ids == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (vtype) {
    case kF32:
      return launch_fused_xw<float, kSched>(
          cols, vals, scales, x, w, b, out, slot_group, slot_start, slot_ids,
          n_chunks, tau, K, F_in, F_out, ldw, k_real, block_rows, block_k,
          kb_ids, n_steps, stream);
    case kBF16:
      return launch_fused_xw<__nv_bfloat16, kSched>(
          cols, vals, scales, x, w, b, out, slot_group, slot_start, slot_ids,
          n_chunks, tau, K, F_in, F_out, ldw, k_real, block_rows, block_k,
          kb_ids, n_steps, stream);
    case kI8:
      return launch_fused_xw<int8_t, kSched>(
          cols, vals, scales, x, w, b, out, slot_group, slot_start, slot_ids,
          n_chunks, tau, K, F_in, F_out, ldw, k_real, block_rows, block_k,
          kb_ids, n_steps, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* fv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// dense: (K, F) with F a whole number of 16-byte pieces and 16-byte
// aligned, like out (R, F) of the otype; slab_cols: slab_width in the
// Python wrapper, a whole number of pieces.
int fv_spmm_dense_grid(const int* cols, const void* vals, const float* scales,
                       const void* dense, void* out, int R, int tau, int K,
                       int F, int block_rows, int block_k, int slab_cols,
                       int vtype, int otype, void* stream) {
  return aggregate<false>(vtype, otype, cols, vals, scales, dense, out,
                          nullptr, R, tau, K, F, block_rows, block_k,
                          slab_cols, (cudaStream_t)stream);
}

// tile_bitmaps: (R / block_rows, ceil(K / block_k / 32)) words, bit kb of
// row rb set when row block rb counts k-tile kb (schedule_tile_bitmaps in
// repro_torch/kernels/flexvector_spmm.py, built once per graph).
int fv_spmm_sparse_grid(const int* cols, const void* vals,
                        const float* scales, const void* dense, void* out,
                        const unsigned* tile_bitmaps, int R, int tau, int K,
                        int F, int block_rows, int block_k, int slab_cols,
                        int vtype, int otype, void* stream) {
  return aggregate<true>(vtype, otype, cols, vals, scales, dense, out,
                         tile_bitmaps, R, tau, K, F, block_rows, block_k,
                         slab_cols, (cudaStream_t)stream);
}

// slot_group / slot_start / slot_ids (n_chunks chunks): column_slots in
// the Python wrapper, slots grouped by kXwRows columns.  x is (K, F_in)
// and w (F_in, ldw) with F_out <= ldw real columns, both with 16-byte
// aligned rows; out (R, F_out) must be zeroed.
int fv_fused_dense_grid(const int* cols, const void* vals, const float* scales,
                        const void* x, const void* w, const float* b,
                        float* out, const int* slot_group,
                        const int* slot_start, const int* slot_ids,
                        int n_chunks, int tau, int K, int F_in, int F_out,
                        int ldw, int k_real, int block_rows, int block_k,
                        int vtype, void* stream) {
  return fused<false>(vtype, cols, vals, scales, x, w, b, out, slot_group,
                      slot_start, slot_ids, n_chunks, nullptr, 0, tau, K,
                      F_in, F_out, ldw, k_real, block_rows, block_k,
                      (cudaStream_t)stream);
}

int fv_fused_sparse_grid(const int* cols, const void* vals,
                         const float* scales, const void* x, const void* w,
                         const float* b, float* out, const int* slot_group,
                         const int* slot_start, const int* slot_ids,
                         int n_chunks, const int* kb_ids, int n_steps, int tau,
                         int K, int F_in, int F_out, int ldw, int k_real,
                         int block_rows, int block_k, int vtype,
                         void* stream) {
  return fused<true>(vtype, cols, vals, scales, x, w, b, out, slot_group,
                     slot_start, slot_ids, n_chunks, kb_ids, n_steps, tau, K,
                     F_in, F_out, ldw, k_real, block_rows, block_k,
                     (cudaStream_t)stream);
}

}  // extern "C"
