// Grouped, interleaved rANS decode scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `decode_grouped_pallas`
// (jxl_tpu/entropy/pallas_rans.py, kernel body `_make_kernel`). Plain
// version: jxl_tpu_torch/entropy/grouped.py:decode_grouped, bit for bit.
//
// One CTA of 128 threads per 128-lane group; thread i owns rANS lane
// g * 128 + i and keeps its 32-bit state in a register while it walks the
// T scan steps. Per step:
//   1. the step's (freq | cum) row is staged in shared memory and a
//      6-probe binary search finds the largest k with cum[k] <= slot;
//   2. x = f * (x >> 12) + slot - cum[k];
//   3. lanes with x < 2^16 renormalise with one u16 word, taken in
//      intra-group rank order (ballot/popc inside each warp plus a 4-warp
//      exclusive prefix in shared memory);
//   4. symbols >= 32 read 1-3 mantissa bytes, ranked the same way (warp
//      shuffle scan of the byte counts);
//   5. the detokenised value is stored.
// The group's word and byte stream pointers are uniform across the CTA and
// live in registers; the final states and pointers are the carry of the
// two-phase decode. Reads past a bucket's end read 0.
//
// What bounds it: the scan is a chain of T dependent steps, each a few
// shared-memory round trips and two __syncthreads. At the bench size only
// G = 2 CTAs run (lanes = 256), so the card is latency-bound with most SMs
// idle, not bandwidth-bound (~20 MB moved in total). The design shortens
// the chain: the next step's row and this step's word/byte windows (the
// 128 words and 384 bytes at the stream pointers) are loaded before the
// symbol search, so no device-memory load sits between two barriers.
// Filling the card (many images per launch, the batched variant) is later
// work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int GROUP = 128;
constexpr int WARPS = GROUP / 32;
constexpr int MAX_NBYTES = 3;
constexpr uint32_t RANS_L = 1u << 16;
constexpr uint32_t SLOT_MASK = (1u << 12) - 1u;

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

__global__ void __launch_bounds__(GROUP) rans_decode_kernel(
    const int32_t* __restrict__ words, int capw,
    const int32_t* __restrict__ mant, int capm,
    const int32_t* __restrict__ rows, int T,
    const uint32_t* __restrict__ states_in, const int32_t* __restrict__ ptrs_in,
    int G, int32_t* __restrict__ values, uint32_t* __restrict__ states_out,
    int32_t* __restrict__ ptrs_out) {
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t lanes = (size_t)G * GROUP;

  // row and warp sums are written only after the barrier that ends the
  // previous step's reads of them; the windows are written before that
  // barrier, so they alternate between two buffers.
  __shared__ int32_t row[GROUP];
  __shared__ int32_t wwin[2][GROUP];
  __shared__ int32_t mwin[2][MAX_NBYTES * GROUP];
  __shared__ int wsum[WARPS];
  __shared__ int bsum[WARPS];

  const int32_t* wg = words + (size_t)g * capw;
  const int32_t* mg = mant + (size_t)g * capm;
  uint32_t x = states_in[(size_t)g * GROUP + tid];
  int gptr = ptrs_in[g];
  int bptr = ptrs_in[G + g];

  int32_t next_row = T > 0 ? rows[tid] : 0;
  for (int t = 0; t < T; ++t) {
    const int buf = t & 1;
    row[tid] = next_row;
    {
      const int i = gptr + tid;
      wwin[buf][tid] = (i >= 0 && i < capw) ? wg[i] : 0;
#pragma unroll
      for (int k = 0; k < MAX_NBYTES; ++k) {
        const int j = bptr + k * GROUP + tid;
        mwin[buf][k * GROUP + tid] = (j >= 0 && j < capm) ? mg[j] : 0;
      }
    }
    if (t + 1 < T) next_row = rows[(size_t)(t + 1) * GROUP + tid];
    __syncthreads();

    const int slot = (int)(x & SLOT_MASK);
    int lo = 0;
#pragma unroll
    for (int p = 32; p >= 1; p >>= 1) {
      if (row[lo + p + 64] <= slot) lo += p;
    }
    const int sym = lo;
    const uint32_t f = (uint32_t)row[sym];
    const uint32_t x_dec = f * (x >> 12) + (uint32_t)(slot - row[sym + 64]);
    const bool need = x_dec < RANS_L;
    const int nbits = sym >= 32 ? sym - 27 : 0;
    const int nbyt = (nbits + 7) >> 3;

    const unsigned ballot = __ballot_sync(0xffffffffu, need);
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

    x = need ? ((x_dec << 16) | (uint32_t)wwin[buf][wpre + wrank]) : x_dec;
    gptr += wtot;

    const int brank = bpre + brank_w;
    uint32_t mval = 0;
#pragma unroll
    for (int j = 0; j < MAX_NBYTES; ++j) {
      if (j < nbyt) mval |= (uint32_t)mwin[buf][brank + j] << (8 * j);
    }
    bptr += btot;

    const uint32_t value = sym >= 32 ? (1u << nbits) + mval : (uint32_t)sym;
    values[(size_t)t * lanes + (size_t)g * GROUP + tid] = (int32_t)value;
  }

  states_out[(size_t)g * GROUP + tid] = x;
  if (tid == 0) {
    ptrs_out[g] = gptr;
    ptrs_out[G + g] = bptr;
  }
}

}  // namespace

// C entry point bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int jxl_rans_decode(const void* words, int capw, const void* mant, int capm,
                               const void* rows, int T, const void* states_in,
                               const void* ptrs_in, int G, void* values,
                               void* states_out, void* ptrs_out, void* stream) {
  rans_decode_kernel<<<G, GROUP, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, capw, (const int32_t*)mant, capm, (const int32_t*)rows, T,
      (const uint32_t*)states_in, (const int32_t*)ptrs_in, G, (int32_t*)values,
      (uint32_t*)states_out, (int32_t*)ptrs_out);
  return (int)cudaGetLastError();
}
