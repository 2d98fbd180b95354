// FlexVector ELL SpMM kernels for Hopper (sm_90a), plain C interface.
//
// Four kernels, one per TPU kernel of src/repro/kernels/flexvector_spmm.py:
//
//   fv_spmm_dense_grid   <- spmm_ell_dense_grid        (pallas_call at :156)
//   fv_spmm_sparse_grid  <- spmm_ell_sparse_grid       (pallas_call at :271)
//   fv_fused_dense_grid  <- spmm_ell_fused_dense_grid  (pallas_call at :426)
//   fv_fused_sparse_grid <- spmm_ell_fused_sparse_grid (pallas_call at :551)
//
// Each C function launches on the given stream, does not synchronise and
// returns cudaGetLastError(); the Python wrappers in
// repro_torch/kernels/flexvector_spmm.py check shapes, dtypes and padding,
// allocate the outputs and raise on a non-zero result.  All sums are f32
// FMA on the CUDA cores (no TF32, no tensor cores).
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
// keeps four 128-byte loads of one dense row in flight per warp.
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

#include <cuda_runtime.h>
#include <stdint.h>

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

template <bool kSched>
__global__ void __launch_bounds__(kThreads) ell_aggregate_kernel(
    const int* __restrict__ cols, const float* __restrict__ vals,
    const float* __restrict__ dense, float* __restrict__ out, int tau, int K,
    int F, int block_rows, int block_k, int block_f,
    const unsigned* __restrict__ tile_bitmaps, int n_kb) {
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

  // Each lane loads and decides one ELL slot of the row (32 at a time);
  // the warp then broadcasts (column, value) slot by slot with shuffles
  // and every lane adds its kAggCols columns of that dense row.
  const int f_end = f0 + block_f;
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

int bitmap_bytes(int n_kb) { return ((n_kb + 31) / 32) * (int)sizeof(unsigned); }

template <bool kSched>
int launch_fused(const int* cols, const float* vals, const float* x,
                 const float* w, const float* b, float* out, int R, int tau,
                 int K, int F_in, int F_out, int k_real, int block_k,
                 const int* kb_ids, int n_steps, cudaStream_t stream) {
  const int n_kb = K / block_k;
  const int dyn = kTM * tau * 8 + (kSched ? bitmap_bytes(n_kb) : 0);
  if (dyn + kFusedStaticSmem > kDefaultSmemLimit) {
    cudaError_t e = cudaFuncSetAttribute(
        ell_fused_kernel<kSched>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        dyn);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((R + kTM - 1) / kTM, (F_out + kTN - 1) / kTN);
  ell_fused_kernel<kSched><<<grid, kThreads, dyn, stream>>>(
      cols, vals, x, w, b, out, R, tau, K, F_in, F_out, k_real, block_k,
      kb_ids, n_steps, n_kb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* fv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int fv_spmm_dense_grid(const int* cols, const float* vals, const float* dense,
                       float* out, int R, int tau, int K, int F,
                       int block_rows, int block_k, int block_f,
                       void* stream) {
  dim3 grid(R / rows_per_cta(block_rows), F / block_f);
  ell_aggregate_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      cols, vals, dense, out, tau, K, F, block_rows, block_k, block_f,
      nullptr, 0);
  return (int)cudaGetLastError();
}

// tile_bitmaps: (R / block_rows, ceil(K / block_k / 32)) words, bit kb of
// row rb set when row block rb counts k-tile kb (schedule_tile_bitmaps in
// repro_torch/kernels/flexvector_spmm.py, built once per graph).
int fv_spmm_sparse_grid(const int* cols, const float* vals, const float* dense,
                        float* out, const unsigned* tile_bitmaps, int R,
                        int tau, int K, int F, int block_rows, int block_k,
                        int block_f, void* stream) {
  const int n_kb = K / block_k;
  const int dyn = bitmap_bytes(n_kb);
  if (dyn > kDefaultSmemLimit) {
    cudaError_t e = cudaFuncSetAttribute(
        ell_aggregate_kernel<true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(R / rows_per_cta(block_rows), F / block_f);
  ell_aggregate_kernel<true><<<grid, kThreads, dyn, (cudaStream_t)stream>>>(
      cols, vals, dense, out, tau, K, F, block_rows, block_k, block_f,
      tile_bitmaps, n_kb);
  return (int)cudaGetLastError();
}

int fv_fused_dense_grid(const int* cols, const float* vals, const float* x,
                        const float* w, const float* b, float* out, int R,
                        int tau, int K, int F_in, int F_out, int k_real,
                        int block_k, void* stream) {
  return launch_fused<false>(cols, vals, x, w, b, out, R, tau, K, F_in, F_out,
                             k_real, block_k, nullptr, 0,
                             (cudaStream_t)stream);
}

int fv_fused_sparse_grid(const int* cols, const float* vals, const float* x,
                         const float* w, const float* b, float* out,
                         const int* kb_ids, int n_steps, int R, int tau, int K,
                         int F_in, int F_out, int k_real, int block_k,
                         void* stream) {
  return launch_fused<true>(cols, vals, x, w, b, out, R, tau, K, F_in, F_out,
                            k_real, block_k, kb_ids, n_steps,
                            (cudaStream_t)stream);
}

}  // extern "C"
