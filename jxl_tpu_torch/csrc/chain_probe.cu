// Latencies of the rANS scans' dependent operations on the card, for the
// chain bounds of jxl_tpu_torch/entropy/kernel_bounds.py.
//
// One warp runs each chain alone, n links long, between two reads of the
// SM cycle counter; every link needs the previous one's result, so the
// cycles over n are the latency of one link. The chains:
//   0 smem_load:   ld.shared of the address the previous load returned;
//   1 imad:        mad.lo.u32 of the previous result (operands known only
//                  at run time, so nothing folds);
//   2 select:      a compare of the previous result and a select on it;
//   3 vote:        a ballot of the previous result's low bit, the popcount
//                  of the lanes below this one and the add into the result;
//   4 decode step: the least a decode step must do in order, per lane: a
//                  one-load lookup of (f, c) for the slot, the multiply-add,
//                  the renormalise test, its rank (a ballot and popcount),
//                  the read of the ranked word from a shared ring and the
//                  merge into the state;
//   5 encode step: rans_enc.cu's state update for one lane (the renormalise
//                  test, the shift it selects, the quotient from the
//                  64-bit reciprocal, the remainder and the new state), its
//                  operands loaded off the chain.
// Not a kernel of the codec: probes/kernels.py launches it once to turn the
// chains into times at the sampled SM clock.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NCHAINS = 6;
constexpr int TAB = 4096;   // slot table and word ring entries
constexpr int CHASE = 1024;
constexpr int NOPS = 64;    // encode operand sets, cycled
constexpr uint32_t RANS_L = 1u << 16;

__device__ __forceinline__ long long clk() {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t)::"memory");
  return t;
}

__device__ __forceinline__ uint32_t mix(uint32_t v) {
  v ^= v >> 16;
  v *= 0x7feb352du;
  v ^= v >> 15;
  v *= 0x846ca68bu;
  return v ^ (v >> 16);
}

// rans_enc.cu's reciprocal M(f) = floor(2^64 / f) + 1 as (hi, lo)
__device__ __forceinline__ uint2 reciprocal(uint32_t f) {
  if (f <= 1) return make_uint2(0, 0);
  uint32_t a = 0xFFFFFFFFu / f;
  uint32_t r = 0xFFFFFFFFu - a * f;
  if (r + 1 == f) {
    a += 1;
    r = 0;
  } else {
    r += 1;
  }
  const uint64_t m = (((uint64_t)a << 32) | (r * a + (r * r) / f)) + 1;
  return make_uint2((uint32_t)(m >> 32), (uint32_t)m);
}

__global__ void __launch_bounds__(32) chain_probe_kernel(int n, uint32_t k, long long* cycles, uint32_t* sink) {
  __shared__ uint32_t tab[TAB];   // slot -> f << 12 | c: 64 symbols of f = 64
  __shared__ uint32_t ring[TAB];  // 16-bit words
  __shared__ uint32_t chase[CHASE];
  __shared__ uint4 ops[NOPS];     // encode: f, c, M hi, M lo
  const int lane = threadIdx.x;
  for (int i = lane; i < TAB; i += 32) {
    tab[i] = 64u << 12 | (uint32_t)(i & ~63);
    ring[i] = mix(i ^ k) & 0xFFFFu;
  }
  for (int i = lane; i < CHASE; i += 32)
    chase[i] = (uint32_t)__cvta_generic_to_shared(&chase[(i * 97 + 13) & (CHASE - 1)]);
  for (int i = lane; i < NOPS; i += 32) {
    const uint32_t f = 2 + mix(i + k) % 4095, c = mix(i * 7 + k) % (4097 - f);
    const uint2 m = reciprocal(f);
    ops[i] = make_uint4(f, c, m.x, m.y);
  }
  __syncwarp();
  unsigned lt;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(lt));
  long long t[NCHAINS + 1];
  uint32_t acc = 0;

  t[0] = clk();
  uint32_t p = (uint32_t)__cvta_generic_to_shared(&chase[lane]);
  for (int i = 0; i < n; ++i) asm volatile("ld.shared.u32 %0, [%0];" : "+r"(p));
  acc += p;
  t[1] = clk();
  uint32_t m = lane;
  for (int i = 0; i < n; ++i) asm volatile("mad.lo.u32 %0, %0, %1, %2;" : "+r"(m) : "r"(k), "r"(k >> 7));
  acc += m;
  t[2] = clk();
  uint32_t v = lane;
  for (int i = 0; i < n; ++i)
    asm volatile("{\n .reg .pred q;\n setp.lt.u32 q, %0, %1;\n selp.b32 %0, %2, %3, q;\n}\n"
                 : "+r"(v) : "r"(k), "r"(k + 1), "r"(k >> 1));
  acc += v;
  t[3] = clk();
  uint32_t w = lane;
  for (int i = 0; i < n; ++i) w += __popc(__ballot_sync(0xffffffffu, w & 1) & lt);
  acc += w;
  t[4] = clk();
  uint32_t x = 1u << 31 | mix(lane + k) >> 1;
  int gptr = 0;
  for (int i = 0; i < n; ++i) {
    const uint32_t slot = x & 0xFFFu, e = tab[slot];
    const uint32_t xd = (e >> 12) * (x >> 12) + slot - (e & 0xFFFu);
    const bool need = xd < RANS_L;
    const unsigned bal = __ballot_sync(0xffffffffu, need);
    const uint32_t wd = ring[(gptr + __popc(bal & lt)) & (TAB - 1)];
    gptr += __popc(bal);
    x = need ? (xd << 16) | wd : xd;
  }
  acc += x;
  t[5] = clk();
  uint32_t y = RANS_L + lane;
  for (int i = 0; i < n; ++i) {
    const uint4 o = ops[i & (NOPS - 1)];
    const uint32_t x1 = (y >> 20) >= o.x ? y >> 16 : y;
    const uint32_t q = o.x == 1 ? x1 : (uint32_t)(((uint64_t)x1 * o.z + __umulhi(x1, o.w)) >> 32);
    y = (q << 12) + (x1 - q * o.x) + o.y;
  }
  acc += y;
  t[6] = clk();
  if (lane == 0)
    for (int j = 0; j < NCHAINS; ++j) cycles[j] = t[j + 1] - t[j];
  sink[lane] = acc;
}

}  // namespace

// C entry point bound with ctypes: each chain n links long; cycles [6]
// int64, sink [32] uint32. Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int jxl_chain_probe(int n, uint32_t k, void* cycles, void* sink, void* stream) {
  chain_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(n, k, (long long*)cycles, (uint32_t*)sink);
  return (int)cudaGetLastError();
}
