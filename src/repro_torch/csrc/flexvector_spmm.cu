// FlexVector ELL SpMM kernels for Hopper (sm_90a), plain C interface.
//
// Four entry points, each covering two TPU kernels of
// src/repro/kernels/flexvector_spmm.py: the f32/bf16 kernel and its int8
// _scaled variant (vtype 2, below):
//
//   fv_spmm_dense_grid   <- spmm_ell_dense_grid        (pallas_call :156, :164)
//   fv_spmm_sparse_grid  <- spmm_ell_sparse_grid       (pallas_call :271, :288)
//   fv_fused_dense_grid  <- spmm_ell_fused_dense_grid  (pallas_call :426, :437)
//   fv_fused_sparse_grid <- spmm_ell_fused_sparse_grid (pallas_call :551, :570)
//
// Storage types (vtype): 0 = f32 values with f32 dense / x / w; 1 = bf16
// values with bf16 dense / x / w; 2 = int8 values times one f32 scale per
// row block (scales[r / block_rows]) with bf16 dense / x / w.  Biases and
// outputs are f32.  Each C function launches on the given stream, does not
// synchronise and returns cudaGetLastError() (or cudaErrorInvalidValue for
// an argument it does not take); the Python wrappers in
// repro_torch/kernels/flexvector_spmm.py check shapes, dtypes and padding,
// allocate the outputs and raise on a non-zero result.  All sums are f32
// FMA on the CUDA cores (no TF32, no tensor cores); a bf16 or int8 operand
// is widened to f32 on load, an int8 value as float(q) * scale, so that
// each term is (float(q) * scale) * float(d) like the TPU kernels'
// a_blk * scale before their f32 dot.
//
// Aggregation (dense grid / sparse grid): out[r,:] = sum_t vals[r,t] *
// dense[cols[r,t],:].  The TPU kernels expand a one-hot (BR, BK) block per
// (row block, k-tile) to feed the MXU and carry the sum from one grid step
// to the next.  Here the same sum is a gather: one CTA per (8 rows of one
// row block, f-tile), so that a PubMed-sized table gives thousands of CTAs
// for 132 SMs; one warp per row, lanes along F so that dense[c, f0:f0+32]
// reads are coalesced, and a loop over the tau slots that skips PAD_COL.
// Nothing accumulates across CTAs.  Bound: bytes.  The work is 2 FLOPs per
// 4+4 bytes of the ELL table plus 4 bytes of a dense row element, far
// below the ~20 FLOP/byte at which the f32 CUDA cores would bound it; the
// design keeps every dense read a coalesced 128-byte segment, reads and
// decides each ELL slot once (one lane per slot, then warp shuffles), and
// keeps four 128-byte loads of one dense row in flight per warp.  With a
// bf16 dense operand a 128-column row is 256 bytes: a half-warp takes one
// slot and a lane loads 8 columns (16 bytes) of it, so a warp still keeps
// 16-byte loads per lane and two slots in flight; the halves' sums are
// added at the end.  Bytes per slot fall from 4 + 4 + 512 (f32) to
// 4 + 2 + 256 (bf16) or 4 + 1 + 256 (int8).
//
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
// >= k_real of X W + b taken as zero.  The TPU keeps the whole (R, BF)
// output slab in VMEM; that does not fit a CTA's shared memory, so the
// sum is re-associated per row: out[r,:] = (sum_t v_t X[c_t,:]) W +
// (sum_t v_t) b.  One CTA per (64 sub-rows, 128 output columns) streams
// F_in in chunks of 32: it gathers the chunk of sum_t v_t X[c_t,:] into
// shared memory, loads the matching (32, 128) slice of W, and accumulates
// an 8x4 register tile per thread.  X W + b never goes to device memory.
// Cost: 2 R F_in F_out FLOPs for the product plus 2 nnz F_in for the
// gather (about 3.3 GFLOP for layer 1 at PubMed's 25,984 x 6 ELL, 500
// inputs and 128 padded outputs); bytes: the ELL table, the referenced
// rows of X (re-read from L2 once per output-column tile), W and the
// output.  Bound: operations on the f32 CUDA cores at these shapes.
// k_real masking cannot change the output for ELL tables the
// preprocessing builds (their columns are always < K); it is kept so the
// contract matches the TPU kernel.  The sparse variant loads kb_ids (-1 =
// no-op step) into a shared-memory bitmap and counts only slots whose
// k-tile is listed.
//
// Fused layer under bf16/int8 (vtype 1, 2): the TPU kernel rounds each row
// of X W + b to bf16 (cast_xw) before it aggregates, and re-association
// cannot reproduce that rounding.  So these kernels keep the TPU kernel's
// own order: one CTA per (64 rows of X, 128 output columns) forms that
// tile of X W + b once in shared memory (bf16 inputs widened to f32, f32
// FMA, + b, rows >= k_real zeroed, rounded to bf16) and then walks the ELL
// slots whose column lies in its 64 rows, adding v * scale * XW[c] into a
// zeroed f32 output with atomicAdd (the atomics take the place of the TPU's
// VMEM-resident output slab).  The slot list per 64-row group is the ELL
// table transposed by column, built once per graph on the host
// (column_slots in the Python wrapper) and cut into chunks of at most 4x
// the mean per group, one chunk per CTA: a hub column's group (437 K of
// Reddit's 24 M slots, against a mean of 6.6 K) would otherwise leave one
// CTA walking it while the card idles.  A chunk recomputes its group's
// tile.  XW never reaches device memory.
// Cost: 2 K F_in F_out FLOPs (the unfused combination's count; a group
// with no slot, or no listed k-tile under the sparse variant, is skipped;
// each extra chunk of a hub group adds one tile)
// plus an atomic add per output column for each run of a row's slots in
// a group, four columns to a 16-byte vector atomic.  The atomics bound
// it at GCN widths: the product is small beside R tau F_out updates.  Order of sums: the
// product's f32 sums run in another order than a library matmul, so an XW
// element near a bf16 rounding boundary can round the other way (one bf16
// ulp), and the atomics add the slots of a row in run-dependent order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Aggregation: columns per lane per pass (a warp covers 32 * kAggCols).
constexpr int kAggCols = 4;

// Fused-kernel tiling: kTM sub-rows x kTN output columns per CTA, F_in
// streamed in chunks of kKC.  Each thread owns an (kTM / kWarps) x
// (kTN / 32) register tile: rows ty + 8 i, columns tx + 32 q.
constexpr int kTM = 64;
constexpr int kTN = 128;
constexpr int kKC = 32;
constexpr int kRowsPerThread = kTM / kWarps;  // 8
constexpr int kColsPerThread = kTN / 32;      // 4
constexpr int kFusedStaticSmem =
    (kTM * kKC + kKC * kTN + kTM) * (int)sizeof(float);
constexpr int kDefaultSmemLimit = 48 * 1024;

// bf16/int8 fused tiling: kXwRows rows of X W + b (XW_TILE_ROWS in the
// Python wrapper) x kXwCols output columns per CTA, F_in streamed in
// chunks of kXwChunk; thread (warp ty, lane tx) owns rows ty + 8 i and
// columns tx + 32 q of the tile, as in ell_fused_kernel.
constexpr int kXwRows = 64;
constexpr int kXwCols = 128;
constexpr int kXwChunk = 32;
constexpr int kXwStaticSmem =
    (kXwRows * kXwChunk + kXwChunk * kXwCols) * (int)sizeof(float) +
    kXwRows * kXwCols * (int)sizeof(__nv_bfloat16) + (int)sizeof(int);

constexpr unsigned kFullMask = 0xffffffffu;

// Storage types of the C interface.
enum VType { kF32 = 0, kBF16 = 1, kI8 = 2 };

// The dense operand (or fused x / w) beside values of type V.
template <typename V>
using Dense = typename std::conditional<std::is_same<V, float>::value, float,
                                        __nv_bfloat16>::type;

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

// Rows per aggregation CTA: one per warp, all inside one row block.
__host__ __device__ int rows_per_cta(int block_rows) {
  return block_rows % kWarps == 0 ? kWarps : block_rows;
}

template <typename V, bool kSched>
__global__ void __launch_bounds__(kThreads) ell_aggregate_kernel(
    const int* __restrict__ cols, const V* __restrict__ vals,
    const float* __restrict__ scales, const Dense<V>* __restrict__ dense,
    float* __restrict__ out, int tau, int K, int F, int block_rows,
    int block_k, int block_f, const unsigned* __restrict__ tile_bitmaps,
    int n_kb, bool vec) {
  extern __shared__ unsigned bitmap[];
  const int n_rows = rows_per_cta(block_rows);
  const int64_t r0 = (int64_t)blockIdx.x * n_rows;
  const int rb = (int)(r0 / block_rows);
  const int f0 = blockIdx.y * block_f;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (kSched) {
    const int words = (n_kb + 31) >> 5;
    const unsigned* src = tile_bitmaps + (int64_t)rb * words;
    for (int i = threadIdx.x; i < words; i += kThreads) bitmap[i] = src[i];
    __syncthreads();
  }

  const int f_end = f0 + block_f;
  if constexpr (std::is_same<V, float>::value) {
  // Each lane loads and decides one ELL slot of the row (32 at a time);
  // the warp then broadcasts (column, value) slot by slot with shuffles
  // and every lane adds its kAggCols columns of that dense row.
  for (int lr = warp; lr < n_rows; lr += kWarps) {
    const int64_t r = r0 + lr;
    for (int fg = f0; fg < f_end; fg += 32 * kAggCols) {
      float acc[kAggCols];
#pragma unroll
      for (int q = 0; q < kAggCols; ++q) acc[q] = 0.f;
      for (int t0 = 0; t0 < tau; t0 += 32) {
        int c_own = -1;
        float v_own = 0.f;
        if (t0 + lane < tau) {
          c_own = cols[r * tau + t0 + lane];
          v_own = vals[r * tau + t0 + lane];
          bool keep = c_own >= 0 && c_own < K;
          if (kSched && keep) keep = tile_listed(bitmap, c_own / block_k);
          if (!keep) c_own = -1;
        }
        const int n_t = min(32, tau - t0);
        for (int j = 0; j < n_t; ++j) {
          const int c = __shfl_sync(0xffffffffu, c_own, j);
          const float v = __shfl_sync(0xffffffffu, v_own, j);
          if (c < 0) continue;  // warp-uniform
          const float* drow = dense + (int64_t)c * F;
#pragma unroll
          for (int q = 0; q < kAggCols; ++q) {
            const int f = fg + lane + 32 * q;
            if (f < f_end) acc[q] = fmaf(v, drow[f], acc[q]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kAggCols; ++q) {
        const int f = fg + lane + 32 * q;
        if (f < f_end) out[r * F + f] = acc[q];
      }
    }
  }
  } else {
  // bf16 dense: half-warp `half` takes the odd or even slots, lane hl of
  // it 8 consecutive columns (one 16-byte load when `vec`: F and block_f
  // multiples of 8, dense 16-byte aligned).
  const float scale = scales != nullptr ? scales[rb] : 1.f;
  const int hl = lane & 15;
  const int half = lane >> 4;
  for (int lr = warp; lr < n_rows; lr += kWarps) {
    const int64_t r = r0 + lr;
    for (int fg = f0; fg < f_end; fg += 128) {
      const int fc = fg + 8 * hl;
      float acc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.f;
      for (int t0 = 0; t0 < tau; t0 += 32) {
        int c_own = -1;
        float v_own = 0.f;
        if (t0 + lane < tau) {
          c_own = cols[r * tau + t0 + lane];
          v_own = to_f32(vals[r * tau + t0 + lane]) * scale;
          bool keep = c_own >= 0 && c_own < K;
          if (kSched && keep) keep = tile_listed(bitmap, c_own / block_k);
          if (!keep) c_own = -1;
        }
        const int n_t = min(32, tau - t0);
        for (int j = 0; j < n_t; j += 2) {
          // lane j + 1 <= n_t holds c_own = -1 when n_t is odd
          const int c = __shfl_sync(kFullMask, c_own, j + half);
          const float v = __shfl_sync(kFullMask, v_own, j + half);
          if (c < 0 || fc >= f_end) continue;
          const __nv_bfloat16* drow = dense + (int64_t)c * F;
          if (vec) {
            const uint4 raw = *reinterpret_cast<const uint4*>(drow + fc);
            const __nv_bfloat162* pair =
                reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 d = __bfloat1622float2(pair[e]);
              acc[2 * e] = fmaf(v, d.x, acc[2 * e]);
              acc[2 * e + 1] = fmaf(v, d.y, acc[2 * e + 1]);
            }
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              if (fc + e < f_end)
                acc[e] = fmaf(v, __bfloat162float(drow[fc + e]), acc[e]);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[e] += __shfl_xor_sync(kFullMask, acc[e], 16);
      if (half == 0 && fc < f_end) {
        float* orow = out + r * F;
        if (vec) {
          reinterpret_cast<float4*>(orow + fc)[0] =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
          reinterpret_cast<float4*>(orow + fc)[1] =
              make_float4(acc[4], acc[5], acc[6], acc[7]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (fc + e < f_end) orow[fc + e] = acc[e];
        }
      }
    }
  }
  }
}

// ---------------------------------------------------------------------------
// Fused layer: dense grid (kSched = false) and sparse grid (kSched = true)
// ---------------------------------------------------------------------------

template <bool kSched>
__global__ void __launch_bounds__(kThreads) ell_fused_kernel(
    const int* __restrict__ cols, const float* __restrict__ vals,
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ b, float* __restrict__ out, int R, int tau,
    int K, int F_in, int F_out, int k_real, int block_k,
    const int* __restrict__ kb_ids, int n_steps, int n_kb) {
  __shared__ float gs[kTM][kKC];   // chunk of sum_t v_t X[c_t, :]
  __shared__ float ws[kKC][kTN];   // chunk of W
  __shared__ float vsum[kTM];      // sum_t v_t: the weight of the bias
  extern __shared__ unsigned char dyn[];
  int* cs = reinterpret_cast<int*>(dyn);          // (kTM, tau), -1 = skip
  float* vs = reinterpret_cast<float*>(cs + kTM * tau);
  unsigned* bitmap = reinterpret_cast<unsigned*>(vs + kTM * tau);

  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int64_t r0 = (int64_t)blockIdx.x * kTM;
  const int n0 = blockIdx.y * kTN;

  if (kSched) {
    zero_bitmap(bitmap, (n_kb + 31) >> 5);
    __syncthreads();
    for (int s = threadIdx.x; s < n_steps; s += kThreads) {
      const int kb = kb_ids[s];
      if (kb >= 0 && kb < n_kb) atomicOr(&bitmap[kb >> 5], 1u << (kb & 31));
    }
    __syncthreads();
  }

  // Stage the tile's ELL slots, keeping only those that count.
  for (int i = threadIdx.x; i < kTM * tau; i += kThreads) {
    int c = -1;
    float v = 0.f;
    if (r0 + i / tau < R) {
      c = cols[r0 * tau + i];
      v = vals[r0 * tau + i];
      bool keep = c >= 0 && c < K && c < k_real;
      if (kSched && keep) keep = tile_listed(bitmap, c / block_k);
      if (!keep) {
        c = -1;
        v = 0.f;
      }
    }
    cs[i] = c;
    vs[i] = v;
  }
  __syncthreads();
  if (threadIdx.x < kTM) {
    float s = 0.f;
    for (int t = 0; t < tau; ++t) s += vs[threadIdx.x * tau + t];
    vsum[threadIdx.x] = s;
  }
  __syncthreads();

  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) acc[i][q] = 0.f;

  for (int k0 = 0; k0 < F_in; k0 += kKC) {
    const int kk = k0 + tx;
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int lr = ty + kWarps * i;
      float g = 0.f;
      if (kk < F_in) {
        for (int t = 0; t < tau; ++t) {
          const int c = cs[lr * tau + t];  // warp-uniform
          if (c >= 0) g = fmaf(vs[lr * tau + t], x[(int64_t)c * F_in + kk], g);
        }
      }
      gs[lr][tx] = g;
    }
    for (int i = threadIdx.x; i < kKC * kTN; i += kThreads) {
      const int j = i / kTN;
      const int n = i % kTN;
      const int kj = k0 + j;
      const int col = n0 + n;
      ws[j][n] = (kj < F_in && col < F_out) ? w[(int64_t)kj * F_out + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < kKC; ++j) {
      float a[kRowsPerThread];
      float bw[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) a[i] = gs[ty + kWarps * i][j];
#pragma unroll
      for (int q = 0; q < kColsPerThread; ++q) bw[q] = ws[j][tx + 32 * q];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int q = 0; q < kColsPerThread; ++q)
          acc[i][q] = fmaf(a[i], bw[q], acc[i][q]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int lr = ty + kWarps * i;
    const int64_t r = r0 + lr;
    if (r >= R) continue;
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) {
      const int col = n0 + tx + 32 * q;
      if (col < F_out) out[r * F_out + col] = fmaf(vsum[lr], b[col], acc[i][q]);
    }
  }
}

// ---------------------------------------------------------------------------
// Fused layer under bf16 / int8: X W + b formed per 64-row tile, rounded to
// bf16, then scattered through the slots of its columns with atomics.
// ---------------------------------------------------------------------------

template <typename V, bool kSched>
__global__ void __launch_bounds__(kThreads) ell_fused_xw_kernel(
    const int* __restrict__ cols, const V* __restrict__ vals,
    const float* __restrict__ scales, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ w, const float* __restrict__ b,
    float* __restrict__ out, const int* __restrict__ slot_group,
    const int* __restrict__ slot_start, const int* __restrict__ slot_ids,
    int tau, int K, int F_in, int F_out, int k_real, int block_rows,
    int block_k, const int* __restrict__ kb_ids, int n_steps, int n_kb,
    bool vec) {
  __shared__ float xs[kXwRows][kXwChunk];          // chunk of X
  __shared__ float ws[kXwChunk][kXwCols];          // chunk of W
  __shared__ __nv_bfloat16 xw[kXwRows][kXwCols];   // round(X W + b)
  __shared__ int any_listed;
  extern __shared__ unsigned bitmap[];

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

  float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) acc[i][q] = 0.f;

  for (int k0 = 0; k0 < F_in; k0 += kXwChunk) {
    for (int i = threadIdx.x; i < kXwRows * kXwChunk; i += kThreads) {
      const int rr = i / kXwChunk;
      const int j = i % kXwChunk;
      const int row = row0 + rr;
      const int kk = k0 + j;
      xs[rr][j] = (row < K && kk < F_in)
                      ? __bfloat162float(x[(int64_t)row * F_in + kk])
                      : 0.f;
    }
    for (int i = threadIdx.x; i < kXwChunk * kXwCols; i += kThreads) {
      const int j = i / kXwCols;
      const int n = i % kXwCols;
      const int kj = k0 + j;
      const int col = n0 + n;
      ws[j][n] = (kj < F_in && col < F_out)
                     ? __bfloat162float(w[(int64_t)kj * F_out + col])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int j = 0; j < kXwChunk; ++j) {
      float a[kRowsPerThread];
      float bw[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) a[i] = xs[ty + kWarps * i][j];
#pragma unroll
      for (int q = 0; q < kColsPerThread; ++q) bw[q] = ws[j][tx + 32 * q];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int q = 0; q < kColsPerThread; ++q)
          acc[i][q] = fmaf(a[i], bw[q], acc[i][q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int lr = ty + kWarps * i;
#pragma unroll
    for (int q = 0; q < kColsPerThread; ++q) {
      const int col = n0 + tx + 32 * q;
      const float v =
          (row0 + lr < k_real && col < F_out) ? acc[i][q] + b[col] : 0.f;
      xw[lr][tx + 32 * q] = __float2bfloat16_rn(v);
    }
  }
  __syncthreads();

  // Each lane decodes one slot of the group (32 per warp at a time); the
  // warp then walks the slots one by one, a lane per 4 columns of XW.
  // Slots are in flat order, so the slots of one output row are
  // consecutive: their terms are summed in registers and the row takes
  // one atomic per lane (one 16-byte vector atomic when `vec`: F_out a
  // multiple of 4 and out 16-byte aligned).  The L2's rate for reduced
  // bytes bounds this loop, so every add that can be left out is.
  const int cl = 4 * tx;  // the lane's first column in the tile
  const int col = n0 + cl;
  for (int base = s_begin + ty * 32; base < s_end; base += kWarps * 32) {
    const int s = base + tx;
    int c_own = -1;
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
    const int n_s = min(32, s_end - base);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < n_s; ++j) {
      const int c = __shfl_sync(kFullMask, c_own, j);
      const float v = __shfl_sync(kFullMask, v_own, j);
      const int r = __shfl_sync(kFullMask, r_own, j);
      const int r_next = __shfl_sync(kFullMask, r_own, (j + 1) & 31);
      if (c < 0) continue;  // warp-uniform
      const __nv_bfloat162* pair =
          reinterpret_cast<const __nv_bfloat162*>(&xw[c][cl]);
      const float2 lo = __bfloat1622float2(pair[0]);
      const float2 hi = __bfloat1622float2(pair[1]);
      acc.x = fmaf(v, lo.x, acc.x);
      acc.y = fmaf(v, lo.y, acc.y);
      acc.z = fmaf(v, hi.x, acc.z);
      acc.w = fmaf(v, hi.y, acc.w);
      if (j + 1 < n_s && r_next == r) continue;  // the row goes on
      // A lane whose four sums are zero (the columns padding W and b to
      // the f-tile, above all) adds nothing: out starts at +0 and x + 0
      // is x for every x but -0, which a sum from +0 never reaches.
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

template <typename V, bool kSched>
int launch_aggregate(const int* cols, const void* vals, const float* scales,
                     const void* dense, float* out,
                     const unsigned* tile_bitmaps, int R, int tau, int K,
                     int F, int block_rows, int block_k, int block_f,
                     cudaStream_t stream) {
  const int n_kb = kSched ? K / block_k : 0;
  const int dyn = kSched ? bitmap_bytes(n_kb) : 0;
  cudaError_t e = allow_smem(ell_aggregate_kernel<V, kSched>, 0, dyn);
  if (e != cudaSuccess) return (int)e;
  const bool vec = ((F | block_f) & 7) == 0 &&
                   (reinterpret_cast<uintptr_t>(dense) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  dim3 grid(R / rows_per_cta(block_rows), F / block_f);
  ell_aggregate_kernel<V, kSched><<<grid, kThreads, dyn, stream>>>(
      cols, static_cast<const V*>(vals), scales,
      static_cast<const Dense<V>*>(dense), out, tau, K, F, block_rows,
      block_k, block_f, tile_bitmaps, n_kb, vec);
  return (int)cudaGetLastError();
}

template <bool kSched>
int aggregate(int vtype, const int* cols, const void* vals,
              const float* scales, const void* dense, float* out,
              const unsigned* tile_bitmaps, int R, int tau, int K, int F,
              int block_rows, int block_k, int block_f, cudaStream_t stream) {
  // scales go with int8 values and only with them
  if ((vtype == kI8) != (scales != nullptr)) return (int)cudaErrorInvalidValue;
  switch (vtype) {
    case kF32:
      return launch_aggregate<float, kSched>(
          cols, vals, scales, dense, out, tile_bitmaps, R, tau, K, F,
          block_rows, block_k, block_f, stream);
    case kBF16:
      return launch_aggregate<__nv_bfloat16, kSched>(
          cols, vals, scales, dense, out, tile_bitmaps, R, tau, K, F,
          block_rows, block_k, block_f, stream);
    case kI8:
      return launch_aggregate<int8_t, kSched>(
          cols, vals, scales, dense, out, tile_bitmaps, R, tau, K, F,
          block_rows, block_k, block_f, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <bool kSched>
int launch_fused(const int* cols, const float* vals, const float* x,
                 const float* w, const float* b, float* out, int R, int tau,
                 int K, int F_in, int F_out, int k_real, int block_k,
                 const int* kb_ids, int n_steps, cudaStream_t stream) {
  const int n_kb = K / block_k;
  const int dyn = kTM * tau * 8 + (kSched ? bitmap_bytes(n_kb) : 0);
  cudaError_t e = allow_smem(ell_fused_kernel<kSched>, kFusedStaticSmem, dyn);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((R + kTM - 1) / kTM, (F_out + kTN - 1) / kTN);
  ell_fused_kernel<kSched><<<grid, kThreads, dyn, stream>>>(
      cols, vals, x, w, b, out, R, tau, K, F_in, F_out, k_real, block_k,
      kb_ids, n_steps, n_kb);
  return (int)cudaGetLastError();
}

template <typename V, bool kSched>
int launch_fused_xw(const int* cols, const void* vals, const float* scales,
                    const void* x, const void* w, const float* b, float* out,
                    const int* slot_group, const int* slot_start,
                    const int* slot_ids, int n_chunks, int tau, int K,
                    int F_in, int F_out, int k_real, int block_rows,
                    int block_k, const int* kb_ids, int n_steps,
                    cudaStream_t stream) {
  if (n_chunks == 0) return (int)cudaSuccess;  // no slot: out stays zero
  const int n_kb = K / block_k;
  const int dyn = kSched ? bitmap_bytes(n_kb) : 0;
  cudaError_t e =
      allow_smem(ell_fused_xw_kernel<V, kSched>, kXwStaticSmem, dyn);
  if (e != cudaSuccess) return (int)e;
  const bool vec = (F_out & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  dim3 grid(n_chunks, (F_out + kXwCols - 1) / kXwCols);
  ell_fused_xw_kernel<V, kSched><<<grid, kThreads, dyn, stream>>>(
      cols, static_cast<const V*>(vals), scales,
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), b, out, slot_group, slot_start,
      slot_ids, tau, K, F_in, F_out, k_real, block_rows, block_k, kb_ids,
      n_steps, n_kb, vec);
  return (int)cudaGetLastError();
}

template <bool kSched>
int fused(int vtype, const int* cols, const void* vals, const float* scales,
          const void* x, const void* w, const float* b, float* out,
          const int* slot_group, const int* slot_start, const int* slot_ids,
          int n_chunks, const int* kb_ids, int n_steps, int R, int tau, int K,
          int F_in, int F_out, int k_real, int block_rows, int block_k,
          cudaStream_t stream) {
  if ((vtype == kI8) != (scales != nullptr)) return (int)cudaErrorInvalidValue;
  if (vtype == kF32)
    return launch_fused<kSched>(
        cols, static_cast<const float*>(vals), static_cast<const float*>(x),
        static_cast<const float*>(w), b, out, R, tau, K, F_in, F_out, k_real,
        block_k, kb_ids, n_steps, stream);
  if (n_chunks > 0 && (slot_group == nullptr || slot_start == nullptr ||
                       slot_ids == nullptr))
    return (int)cudaErrorInvalidValue;
  if (vtype == kBF16)
    return launch_fused_xw<__nv_bfloat16, kSched>(
        cols, vals, scales, x, w, b, out, slot_group, slot_start, slot_ids,
        n_chunks, tau, K, F_in, F_out, k_real, block_rows, block_k, kb_ids,
        n_steps, stream);
  if (vtype == kI8)
    return launch_fused_xw<int8_t, kSched>(
        cols, vals, scales, x, w, b, out, slot_group, slot_start, slot_ids,
        n_chunks, tau, K, F_in, F_out, k_real, block_rows, block_k, kb_ids,
        n_steps, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* fv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int fv_spmm_dense_grid(const int* cols, const void* vals, const float* scales,
                       const void* dense, float* out, int R, int tau, int K,
                       int F, int block_rows, int block_k, int block_f,
                       int vtype, void* stream) {
  return aggregate<false>(vtype, cols, vals, scales, dense, out, nullptr, R,
                          tau, K, F, block_rows, block_k, block_f,
                          (cudaStream_t)stream);
}

// tile_bitmaps: (R / block_rows, ceil(K / block_k / 32)) words, bit kb of
// row rb set when row block rb counts k-tile kb (schedule_tile_bitmaps in
// repro_torch/kernels/flexvector_spmm.py, built once per graph).
int fv_spmm_sparse_grid(const int* cols, const void* vals,
                        const float* scales, const void* dense, float* out,
                        const unsigned* tile_bitmaps, int R, int tau, int K,
                        int F, int block_rows, int block_k, int block_f,
                        int vtype, void* stream) {
  return aggregate<true>(vtype, cols, vals, scales, dense, out, tile_bitmaps,
                         R, tau, K, F, block_rows, block_k, block_f,
                         (cudaStream_t)stream);
}

// slot_group / slot_start / slot_ids (n_chunks chunks): column_slots in
// the Python wrapper, slots grouped by kXwRows columns (bf16 / int8 only;
// the f32 kernel takes null pointers and 0 there).  out must be zeroed
// for bf16 / int8.
int fv_fused_dense_grid(const int* cols, const void* vals, const float* scales,
                        const void* x, const void* w, const float* b,
                        float* out, const int* slot_group,
                        const int* slot_start, const int* slot_ids,
                        int n_chunks, int R, int tau, int K, int F_in,
                        int F_out, int k_real, int block_rows, int block_k,
                        int vtype, void* stream) {
  return fused<false>(vtype, cols, vals, scales, x, w, b, out, slot_group,
                      slot_start, slot_ids, n_chunks, nullptr, 0, R, tau, K,
                      F_in, F_out, k_real, block_rows, block_k,
                      (cudaStream_t)stream);
}

int fv_fused_sparse_grid(const int* cols, const void* vals,
                         const float* scales, const void* x, const void* w,
                         const float* b, float* out, const int* slot_group,
                         const int* slot_start, const int* slot_ids,
                         int n_chunks, const int* kb_ids, int n_steps, int R,
                         int tau, int K, int F_in, int F_out, int k_real,
                         int block_rows, int block_k, int vtype,
                         void* stream) {
  return fused<true>(vtype, cols, vals, scales, x, w, b, out, slot_group,
                     slot_start, slot_ids, n_chunks, kb_ids, n_steps, R, tau,
                     K, F_in, F_out, k_real, block_rows, block_k,
                     (cudaStream_t)stream);
}

}  // extern "C"
