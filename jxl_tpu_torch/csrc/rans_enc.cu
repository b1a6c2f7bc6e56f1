// Grouped rANS encode scan with in-order stream emission, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `encode_grouped_pallas`
// (jxl_tpu/entropy/pallas_rans_enc.py, kernel body `_make_enc_kernel`).
// Plain version: jxl_tpu_torch/entropy/cuda_rans_enc.py:encode_grouped_plain
// (grouped.rans_encode_grouped + grouped.pack_mantissa_grouped), bit for
// bit.
//
// One CTA of 128 threads per 128-lane group; thread i owns rANS lane
// g * 128 + i. rANS encodes back to front, so the CTA walks the steps from
// T - 1 down to 0 starting from x = 2^16. Per step and lane:
//   1. (f, c) of the lane's token come from the step's row in shared memory;
//   2. if x >> 20 >= f the low 16 bits of x are emitted and x >>= 16;
//   3. x = (x / f) << 12 + x % f + c.
// Emitted words are stored straight at their final place: the group's
// bucket is back-filled from its end, the step's words at
// [ptr - count, ptr) in lane order (rank = ballot/popc inside each warp
// plus a 4-warp exclusive prefix), so the bucket ends up holding the
// group's stream at [capw - wcount, capw) in decoder consumption order.
// Mantissa bytes (ceil((tok - 27) / 8) per token >= 32, little-endian) are
// back-filled the same way into their own bucket. Counts keep growing past
// a cap, but nothing is written outside a bucket: the wrapper sees
// count > cap and launches again with larger buckets.
//
// What bounds it: like the decoder, a chain of T dependent steps with two
// __syncthreads each, run by only G CTAs (G = 2 at the bench size), so it
// is latency-bound with most SMs idle. The next step's row, tokens and
// mantissas are loaded one step ahead so that no device-memory load sits
// on the chain; the stores are fire-and-forget.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int GROUP = 128;
constexpr int WARPS = GROUP / 32;
constexpr int MAX_NBYTES = 3;
constexpr uint32_t RANS_L = 1u << 16;

__device__ __forceinline__ int warp_exclusive_scan(int v, int lane, int* total) {
  int s = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += n;
  }
  *total = __shfl_sync(0xffffffffu, s, 31);
  return s - v;
}

__global__ void __launch_bounds__(GROUP) rans_encode_kernel(
    const int32_t* __restrict__ tok, const int32_t* __restrict__ mant,
    const int32_t* __restrict__ rows, int T, int G, int capw, int capm,
    int32_t* __restrict__ words, int32_t* __restrict__ mbytes,
    uint32_t* __restrict__ states, int32_t* __restrict__ counts) {
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t lanes = (size_t)G * GROUP;
  const size_t col = (size_t)g * GROUP + tid;

  __shared__ int32_t row[GROUP];
  __shared__ int wsum[WARPS];
  __shared__ int bsum[WARPS];

  int32_t* wg = words + (size_t)g * capw;
  int32_t* mg = mbytes + (size_t)g * capm;
  uint32_t x = RANS_L;
  int wptr = capw;
  int bptr = capm;

  int32_t next_row = 0, next_tok = 0, next_mant = 0;
  if (T > 0) {
    next_row = rows[(size_t)(T - 1) * GROUP + tid];
    next_tok = tok[(size_t)(T - 1) * lanes + col];
    next_mant = mant[(size_t)(T - 1) * lanes + col];
  }
  for (int t = T - 1; t >= 0; --t) {
    row[tid] = next_row;
    const int tk = next_tok;
    const uint32_t m = (uint32_t)next_mant;
    if (t > 0) {
      next_row = rows[(size_t)(t - 1) * GROUP + tid];
      next_tok = tok[(size_t)(t - 1) * lanes + col];
      next_mant = mant[(size_t)(t - 1) * lanes + col];
    }
    __syncthreads();

    const uint32_t f = (uint32_t)row[tk];
    const uint32_t c = (uint32_t)row[tk + 64];
    const bool emit = (x >> 20) >= f;
    const int32_t word = (int32_t)(x & 0xFFFFu);
    const uint32_t x1 = emit ? (x >> 16) : x;
    x = ((x1 / f) << 12) + x1 % f + c;

    const int nbits = tk >= 32 ? tk - 27 : 0;
    const int nbyt = (nbits + 7) >> 3;
    const unsigned ballot = __ballot_sync(0xffffffffu, emit);
    const int wrank = __popc(ballot & ((1u << lane) - 1u));
    int btot_w;
    const int brank_w = warp_exclusive_scan(nbyt, lane, &btot_w);
    if (lane == 0) {
      wsum[warp] = __popc(ballot);
      bsum[warp] = btot_w;
    }
    __syncthreads();

    int wpre = 0, wtot = 0, bpre = 0, btot = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int ws = wsum[w], bs = bsum[w];
      if (w < warp) {
        wpre += ws;
        bpre += bs;
      }
      wtot += ws;
      btot += bs;
    }

    const int wnew = wptr - wtot;
    if (emit) {
      const int p = wnew + wpre + wrank;
      if (p >= 0) wg[p] = word;
    }
    const int bnew = bptr - btot;
    const int bbase = bnew + bpre + brank_w;
#pragma unroll
    for (int j = 0; j < MAX_NBYTES; ++j) {
      const int p = bbase + j;
      if (j < nbyt && p >= 0) mg[p] = (int32_t)((m >> (8 * j)) & 0xFFu);
    }
    wptr = wnew;
    bptr = bnew;
  }

  states[col] = x;
  if (tid == 0) {
    counts[g] = capw - wptr;
    counts[G + g] = capm - bptr;
  }
}

}  // namespace

// C entry point bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched). words/mbytes must arrive zeroed.
extern "C" int jxl_rans_encode(const void* tok, const void* mant, const void* rows, int T,
                               int G, int capw, int capm, void* words, void* mbytes,
                               void* states, void* counts, void* stream) {
  rans_encode_kernel<<<G, GROUP, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tok, (const int32_t*)mant, (const int32_t*)rows, T, G, capw, capm,
      (int32_t*)words, (int32_t*)mbytes, (uint32_t*)states, (int32_t*)counts);
  return (int)cudaGetLastError();
}
