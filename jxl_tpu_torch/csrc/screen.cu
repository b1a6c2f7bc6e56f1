// The modular / VarDCT pre-screen's count, for Hopper (sm_90a).
//
// Replaces no TPU kernel: jxl_tpu computes the screen in host numpy
// (jxl_tpu/codec/encode.py:_modular_candidate). It was added because the
// port's encoder had already uploaded the frame to the card, and numpy on
// the host took ~0.5 s of a ~0.7 s encode of a 4032x3024 frame.
// Plain version: jxl_tpu_torch/codec/screen.py:screen_plain, count for
// count.
//
// Computes: over the grid a[::s, ::s] of a contiguous u8 [H, W, 3] frame a
// (s = 1, or 4 above 2^24 pixels), the number of grid pixels (i, j),
// i >= 1, j >= 1, whose three bytes equal both the west (i, j - 1) and the
// north (i - 1, j) grid neighbour's, added to one u64 counter that the
// wrapper has zeroed.
//
// What bounds it on an H100: reading the grid's bytes once. At s = 1 that
// is the frame, 3 H W bytes: 36.58 MB at 4032x3024, 10.9 us at 3.35 TB/s.
// At s = 4 every fourth row is read, and all of its 32-byte sectors (a
// pixel every 12 bytes), so a quarter of the frame. The arithmetic is a
// few integer operations a pixel, far under that.
//
// The design streams each byte from device memory once:
//   * a CTA of THREADS threads owns a tile of TILE grid columns and a band
//     of BAND grid rows; thread t holds the columns c0 + t + THREADS k,
//     k < PIX, so one warp's load of a row covers 32 neighbouring pixels
//     (96 contiguous bytes at s = 1);
//   * the CTA walks its band top to bottom, and each thread keeps its
//     pixels of the previous row in registers: the north neighbour is
//     never read again (only the row above the band is, once, mostly from
//     L2, where the band above has just brought it);
//   * the west neighbour comes from the next lower lane by one shuffle;
//     lane 0 reads its own from memory, from the lines its neighbour warp
//     has just loaded;
//   * a pixel is its three bytes packed into a u32, so each test is one
//     compare; a column past the grid holds a value no pixel packs to;
//   * hits add up in a register, then across the warp by shuffles and
//     across the CTA's warps in shared memory, and thread 0 adds the
//     CTA's sum to the counter with one atomicAdd (none for a sum of 0, as
//     on most CTAs of a photograph).
// Nothing is allocated, nothing synchronises with the host; the launch
// runs on the stream it is given. Measured on an H100 80GB HBM3 at 700 W
// (then the card script, now probes/kernels.py): 34.75 us at 4032x3024,
// 31% of the bound; 16.87 us at 4097x4096 (s = 4); ptxas: 40 registers,
// no spills.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int PIX = 4;                // grid columns a thread
constexpr int TILE = THREADS * PIX;  // grid columns a CTA
constexpr int BAND = 8;               // grid rows a CTA
constexpr uint32_t PAST = 0xFFFFFFFFu;  // a packed pixel is < 2^24

__device__ __forceinline__ uint32_t pixel(const uint8_t* __restrict__ img, int r, int c, int W, int s) {
  const uint8_t* p = img + ((size_t)r * s * W + (size_t)c * s) * 3;
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16);
}

__global__ void __launch_bounds__(THREADS) screen_kernel(const uint8_t* __restrict__ img, int W, int s,
                                                         int Hs, int Ws, unsigned long long* out) {
  const int lane = threadIdx.x & 31;
  const int r0 = 1 + blockIdx.x * BAND;
  const int r1 = min(Hs, r0 + BAND);
  const int c0 = blockIdx.y * TILE + threadIdx.x;
  uint32_t prev[PIX];
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    const int c = c0 + k * THREADS;
    prev[k] = c < Ws ? pixel(img, r0 - 1, c, W, s) : PAST;
  }
  unsigned int hits = 0;
  for (int r = r0; r < r1; ++r) {
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      const int c = c0 + k * THREADS;
      const uint32_t v = c < Ws ? pixel(img, r, c, W, s) : PAST;
      uint32_t west = __shfl_up_sync(0xFFFFFFFFu, v, 1);
      if (lane == 0 && c >= 1 && c < Ws) west = pixel(img, r, c - 1, W, s);
      hits += (c >= 1 && c < Ws && v == west && v == prev[k]) ? 1u : 0u;
      prev[k] = v;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) hits += __shfl_down_sync(0xFFFFFFFFu, hits, o);
  __shared__ unsigned int warp_hits[WARPS];
  if (lane == 0) warp_hits[threadIdx.x >> 5] = hits;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += warp_hits[w];
    if (sum) atomicAdd(out, sum);
  }
}

}  // namespace

// img: contiguous u8 [H, W, 3]; s >= 1 with at least two grid rows and two
// grid columns (the wrapper checks both); out: one zeroed u64.
extern "C" int jxl_screen_count(const void* img, int H, int W, int s, void* out, void* stream) {
  const int Hs = (H + s - 1) / s, Ws = (W + s - 1) / s;
  const dim3 grid((Hs - 1 + BAND - 1) / BAND, (Ws + TILE - 1) / TILE);
  screen_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>((const uint8_t*)img, W, s, Hs, Ws,
                                                            (unsigned long long*)out);
  return (int)cudaGetLastError();
}
