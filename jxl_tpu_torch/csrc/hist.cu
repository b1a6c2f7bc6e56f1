// H1: the encoder's context histograms, for Hopper (sm_90a).
//
// Replaces no TPU kernel: jxl_tpu computes these counts as one-hot
// reductions that XLA fuses (jxl_tpu/codec/encode.py:578 and :613: small
// exact counts first, then one add a bin). torch.bincount's CUDA kernel
// (ATen's kernelHistogram1D) takes one global atomicAdd a token once the
// bins (39,780 or 39,312 int64) outgrow its shared-memory path, on a few
// hot bins, after an int64 index array is built and its min and max are
// read back to the host: ~16 ms of a 12 MP encode on an H100.
// Plain versions: jxl_tpu_torch/codec/histogram.py:histogram_stepped_plain
// and ac_counts4_plain (torch.bincount), count for count.
//
// Computes, added into a zeroed int64 output the wrapper allocates:
//   * the stepped form (nb = 0): for each step t < n_keys, its group
//     tokens tok[t * group + k] counted in row key[t] of out [n_rows, A]
//     (the padded rANS stream: group = lanes, one context a step);
//   * the AC form (nb > 0): the AC tokens tok[(c * nb + b) * 63 + p],
//     c < 3, counted in row (c * 63 + p) * NNZ_Q + key[c * nb + b] of
//     out [3 * 63 * NNZ_Q, A] (group = 63, n_keys = 3 nb: the nnz bucket
//     of each block).
// A token outside [0, A), or a row outside [0, n_rows), is not counted
// (torch.bincount would have widened its output instead; the encoder's
// tokens and contexts lie in range by construction).
//
// What bounds it on an H100: reading the tokens (4 bytes each) and the
// keys (8 bytes each) once. At 12 MP that is 37.6 M tokens in the stepped
// form and 36.0 M in the AC form, ~150 MB each: ~45 us at 3.35 TB/s. A
// token costs a few integer operations and one shared-memory update; the
// output is ~0.3 MB.
//
// The design keeps every per-token update in shared memory and sends the
// device's memory only a few atomics a CTA:
//   * stepped form: a CTA of 128 threads walks a contiguous range of
//     steps. Consecutive steps mostly share a context, so it finds each run
//     of equal contexts (the keys read once, a block-wide OR for the run's
//     end) and streams the run's tokens as 16-byte loads. Each thread
//     counts into its own column of an int32 [A][128] tally: a token is a
//     shared load and store in the thread's own bank, with no atomic and no
//     conflict however skewed the tokens are (most are 0, so an atomic
//     tally would serialise on one address). At the end of a run each warp
//     sums 13 bins over the 128 columns (one warp reduction a bin) and adds
//     each nonzero bin to the run's row with one 64-bit global atomicAdd.
//   * AC form: a CTA of 512 threads takes one channel and a tile of
//     AC_BLOCKS blocks and holds the channel's [NNZ_Q][A][64] int32 tally
//     (53,248 bytes of dynamic shared memory, opted in at each launch).
//     Threads read consecutive tokens, so the 32 lanes of a warp hold 32
//     different positions: their shared atomicAdds never meet on one
//     address, and with the position as the fastest index they fall in
//     different banks. At the end the nonzero bins go out with one 64-bit
//     global atomicAdd each.
// Integer atomics are exact in any order, so two launches give the same
// counts. Nothing is allocated, nothing synchronises with the host; the
// launch runs on the stream it is given.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int A = 52;       // token alphabet (entropy/tokens.py:ALPHABET)
constexpr int NNZ_Q = 4;    // nnz buckets (codec/layout.py:NNZ_Q)
constexpr int AC_POS = 63;  // AC positions of a block
constexpr int POS_PAD = 64;

constexpr int S_THREADS = 128;
constexpr int S_WARPS = S_THREADS / 32;
constexpr int S_TOKENS = 32768;  // tokens a CTA of the stepped form (at least one step)
constexpr int S_UNROLL = 4;

constexpr int AC_THREADS = 512;
constexpr int AC_BLOCKS = 512;  // blocks of one channel a CTA of the AC form
constexpr int AC_TALLY = NNZ_Q * A * POS_PAD;
constexpr int AC_UNROLL = 4;

__device__ __forceinline__ void count1(unsigned* col, int v) {
  if ((unsigned)v < (unsigned)A) col[v * S_THREADS] += 1u;
}

__device__ __forceinline__ void count4(unsigned* col, int4 v) {
  count1(col, v.x);
  count1(col, v.y);
  count1(col, v.z);
  count1(col, v.w);
}

__global__ void __launch_bounds__(S_THREADS)
    hist_stepped_kernel(const int4* __restrict__ tok4, const long long* __restrict__ key, int T, int group4,
                        int steps_per_cta, int n_rows, unsigned long long* __restrict__ out) {
  __shared__ unsigned tally[A * S_THREADS];  // [bin][thread]
  __shared__ int run_end;                     // relative to the CTA's first step
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned* col = tally + tid;
#pragma unroll 4
  for (int b = 0; b < A; ++b) col[b * S_THREADS] = 0u;
  const int s0 = blockIdx.x * steps_per_cta;
  const int n = min(T - s0, steps_per_cta);
  for (int s = 0; s < n;) {
    const long long ctx = key[s0 + s];
    // the end of the run of steps whose context is ctx
    if (tid == 0) run_end = n;
    __syncthreads();
    for (int base = s + 1; base < n; base += S_THREADS) {
      const int j = base + tid;
      const bool diff = j < n && key[s0 + j] != ctx;
      if (diff) atomicMin(&run_end, j);
      if (__syncthreads_or(diff)) break;
    }
    const int e = run_end;
    // the run's tokens, 16 bytes a load, into this thread's column
    const long long i1 = (long long)(s0 + e) * group4;
    long long i = (long long)(s0 + s) * group4 + tid;
    for (; i + (S_UNROLL - 1) * S_THREADS < i1; i += S_UNROLL * S_THREADS) {
      int4 v[S_UNROLL];
#pragma unroll
      for (int u = 0; u < S_UNROLL; ++u) v[u] = __ldcs(tok4 + i + u * S_THREADS);
#pragma unroll
      for (int u = 0; u < S_UNROLL; ++u) count4(col, v[u]);
    }
    for (; i < i1; i += S_THREADS) count4(col, __ldcs(tok4 + i));
    __syncthreads();
    // flush: warp w sums bins w, w + S_WARPS, ... over the columns
    const bool valid = ctx >= 0 && ctx < n_rows;
    for (int b = warp; b < A; b += S_WARPS) {
      unsigned* row = tally + b * S_THREADS;
      unsigned sum = 0u;
#pragma unroll
      for (int k = lane; k < S_THREADS; k += 32) {
        sum += row[k];
        row[k] = 0u;
      }
      sum = __reduce_add_sync(0xFFFFFFFFu, sum);
      if (lane == 0 && sum && valid) atomicAdd(out + ctx * A + b, (unsigned long long)sum);
    }
    __syncthreads();
    s = e;
  }
}

__device__ __forceinline__ void count_ac(unsigned* tally, int v, long long q, int p) {
  if ((unsigned)v < (unsigned)A && (unsigned long long)q < (unsigned long long)NNZ_Q)
    atomicAdd(tally + ((int)q * A + v) * POS_PAD + p, 1u);
}

__global__ void __launch_bounds__(AC_THREADS)
    hist_ac_kernel(const int* __restrict__ tok, const long long* __restrict__ key, int nb,
                   unsigned long long* __restrict__ out) {
  extern __shared__ unsigned ac_tally[];  // [NNZ_Q][A][POS_PAD]
  const int c = blockIdx.y;
  const int b0 = blockIdx.x * AC_BLOCKS;
  const int n = min(nb - b0, AC_BLOCKS) * AC_POS;
  for (int i = threadIdx.x; i < AC_TALLY; i += AC_THREADS) ac_tally[i] = 0u;
  __syncthreads();
  const int* t = tok + ((long long)c * nb + b0) * AC_POS;
  const long long* q = key + (long long)c * nb + b0;
  int i = threadIdx.x;
  for (; i + (AC_UNROLL - 1) * AC_THREADS < n; i += AC_UNROLL * AC_THREADS) {
    int v[AC_UNROLL], p[AC_UNROLL];
    long long qq[AC_UNROLL];
#pragma unroll
    for (int u = 0; u < AC_UNROLL; ++u) {
      const int e = i + u * AC_THREADS;
      const int blk = e / AC_POS;
      p[u] = e - blk * AC_POS;
      v[u] = __ldcs(t + e);
      qq[u] = q[blk];
    }
#pragma unroll
    for (int u = 0; u < AC_UNROLL; ++u) count_ac(ac_tally, v[u], qq[u], p[u]);
  }
  for (; i < n; i += AC_THREADS) {
    const int blk = i / AC_POS;
    count_ac(ac_tally, __ldcs(t + i), q[blk], i - blk * AC_POS);
  }
  __syncthreads();
  unsigned long long* o = out + (long long)c * AC_POS * NNZ_Q * A;
  for (int j = threadIdx.x; j < AC_TALLY; j += AC_THREADS) {
    const unsigned v = ac_tally[j];
    if (v) {
      const int p = j % POS_PAD, rest = j / POS_PAD;
      atomicAdd(o + (p * NNZ_Q + rest / A) * A + rest % A, (unsigned long long)v);
    }
  }
}

}  // namespace

// tok: int32 [n_keys * group], 16-byte aligned; key: int64 [n_keys];
// out: zeroed int64 [n_rows, A]. nb = 0: the stepped form (group a
// positive multiple of 4). nb > 0: the AC form (group 63, n_keys 3 nb,
// n_rows 3 * 63 * NNZ_Q). Returns cudaErrorInvalidValue for other shapes.
extern "C" int jxl_hist(const void* tok, const void* key, int n_keys, int group, int n_rows, int nb, void* out,
                        void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n_keys < 0 || group <= 0 || n_rows <= 0 || nb < 0) return (int)cudaErrorInvalidValue;
  if (n_keys == 0) return 0;
  if (nb == 0) {
    if (group % 4 != 0 || ((uintptr_t)tok & 15) != 0) return (int)cudaErrorInvalidValue;
    const int steps = group >= S_TOKENS ? 1 : S_TOKENS / group;
    const int grid = (n_keys + steps - 1) / steps;
    hist_stepped_kernel<<<grid, S_THREADS, 0, st>>>((const int4*)tok, (const long long*)key, n_keys, group / 4, steps,
                                                    n_rows, (unsigned long long*)out);
    return (int)cudaGetLastError();
  }
  if (group != AC_POS || n_keys != 3 * nb || n_rows != 3 * AC_POS * NNZ_Q) return (int)cudaErrorInvalidValue;
  const int smem = AC_TALLY * (int)sizeof(unsigned);
  cudaError_t err = cudaFuncSetAttribute(hist_ac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nb + AC_BLOCKS - 1) / AC_BLOCKS, 3);
  hist_ac_kernel<<<grid, AC_THREADS, smem, st>>>((const int*)tok, (const long long*)key, nb,
                                                 (unsigned long long*)out);
  return (int)cudaGetLastError();
}
