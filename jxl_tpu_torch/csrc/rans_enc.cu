// Grouped rANS encode scan with in-order stream emission, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `encode_grouped_pallas`
// (jxl_tpu/entropy/pallas_rans_enc.py, kernel body `_make_enc_kernel`).
// Plain version: jxl_tpu_torch/entropy/cuda_rans_enc.py:encode_grouped_plain
// (grouped.rans_encode_grouped + grouped.pack_mantissa_grouped), bit for
// bit.
//
// rANS encodes back to front: each 128-lane group walks the steps from
// T - 1 down to 0 starting from x = 2^16. Per step and lane:
//   1. (f, c) of the lane's token come from the step's row;
//   2. if x >> 20 >= f the low 16 bits of x are emitted and x >>= 16;
//   3. x = (x / f) << 12 + x % f + c.
// Emitted words go to their final place: the group's bucket is
// back-filled from its end, the step's words at
// [ptr - count, ptr) in lane order, so the bucket ends up holding the
// group's stream at [capw - wcount, capw) in decoder consumption order.
// Mantissa bytes (ceil((tok - 27) / 8) per token >= 32, little-endian) are
// back-filled the same way into their own bucket. Counts keep growing past
// a cap, but nothing is written outside a bucket: the wrapper sees
// count > cap and launches again with larger buckets.
//
// What bounds it on an H100: a chain of T dependent steps per group, run
// by only G = 2 groups at the bench shape (lanes 256, T 4731). The
// roofline bound (tokens, mantissas and rows read once, the words and
// bytes written once, at 3.35 TB/s) is 3.7 us; the chain bound, T times
// the latency of the renormalise test, the division and the state update,
// is 0.123 ms: 51.4 SM cycles a step, this kernel's state update measured
// alone on the card by csrc/chain_probe.cu (jxl_tpu_torch/entropy/
// kernel_bounds.py makes the bounds). Measured on an H100 80GB HBM3 at
// 700 W, SM clock 1980 MHz, in turns with the previous design
// (then probes/rans_kernels.py, now probes/kernels.py --parent-csrc):
// 1.152 ms, 482 cycles a step, 10.7% of the chain bound; the previous
// design (four warps, one lane a thread, each step's inputs loaded one
// step ahead, the emulated 32-bit division, two block barriers a step)
// took 1.618 ms.
//
// The design: two warps per group that share nothing, so no barrier of
// any kind sits in either loop.
//   * warp 0 owns the states and the words, thread j lanes 4j..4j+3. The
//     step's row and tokens do not depend on the state: they stream into a
//     shared-memory ring of SLOTS steps with cp.async, AHEAD chunks of
//     CHUNK steps ahead, and a chunk's (f, c, reciprocal) operands are all
//     read before its steps run, so the chain itself touches registers
//     only. Word ranks (one ballot per lane position k, as in the decoder)
//     place the emitted words in a shared-memory staging ring, written out
//     to the bucket in order at the next chunk's start;
//   * warp 1 packs the mantissa bytes, which depend on the tokens alone:
//     its own ring of tokens and mantissas, byte ranks from ballots of the
//     byte counts' 5 bit planes, its own staging ring and write-out;
//   * each warp waits for a chunk's copies and crosses one __syncwarp at
//     the chunk's start only;
//   * the division by f (1 <= f <= 4096) is a multiply by a reciprocal
//     from a per-CTA table built at the start: M(f) = floor(2^64 / f) + 1,
//     i.e. M = (2^64 + e) / f with 0 < e <= f, and q = floor(x M / 2^64).
//     Then x M / 2^64 = x / f + x e / (f 2^64), where the error term is
//     below 1 / f because x e < 2^32 * 2^12 < 2^64 and the fraction of
//     x / f is at most (f - 1) / f: the floor is exactly floor(x / f) for
//     every 32-bit x (the round-up method of Granlund and Montgomery,
//     "Division by invariant integers using multiplication", PLDI 1994,
//     with a 64-bit multiplier). f = 1 (M would need 65 bits) takes q = x.
//     M is built from two 32-bit divisions: 2^32 = a f + r gives
//     floor(2^64 / f) = a 2^32 + r a + floor(r^2 / f). The remainder is
//     x - q f.
//
// Shared memory per CTA: 77,840 B (warp 0: two rings of SLOTS * 128 int32,
// STAGE_W staged words, the 4097-entry table; warp 1: two rings, STAGE_B
// staged bytes; dynamic, the attribute is set before each launch). ptxas:
// 93 registers, no spills (probes/kernels.py prints it).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int GROUP = 128;
constexpr int LPT = 4;  // lanes per thread
constexpr int MAX_NBYTES = 3;
constexpr uint32_t RANS_L = 1u << 16;
constexpr int RANS_M = 4096;

constexpr int CHUNK = 4;  // steps per ring chunk
constexpr int AHEAD = 3;  // chunks in flight ahead of the one encoded
constexpr int SLOTS = 16;
static_assert(SLOTS >= (AHEAD + 1) * CHUNK, "ring too small");
// staging rings of the emitted words (int32) and mantissa bytes (u8): a
// chunk's output is written out at the next chunk's start, so each holds
// two chunks' worth at the most a step can emit (128 words; 5 bytes per
// lane for tokens up to 63, the row's width)
constexpr int STAGE_W = 1024;
constexpr int STAGE_B = 8192;
static_assert(STAGE_W >= 2 * CHUNK * GROUP && STAGE_B >= 2 * CHUNK * 5 * GROUP, "staging too small");
constexpr int WORDS_SMEM = 2 * SLOTS * GROUP * 4 + STAGE_W * 4 + (RANS_M + 1) * 8 + 8;  // 16-byte multiple
constexpr int SMEM_BYTES = WORDS_SMEM + 2 * SLOTS * GROUP * 4 + STAGE_B;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Exclusive warp prefix (and total) of a per-thread byte count (< 32: 4
// lanes of at most 5 bytes), from ballots of its 5 bit planes.
__device__ __forceinline__ int byte_prefix(int v, unsigned lt, int* total) {
  int pre = 0, tot = 0;
#pragma unroll
  for (int p = 0; p < 5; ++p) {
    const unsigned bal = __ballot_sync(0xffffffffu, (v >> p) & 1);
    pre += __popc(bal & lt) << p;
    tot += __popc(bal) << p;
  }
  *total = tot;
  return pre;
}

// 128 int32 from device memory into a shared slot, by the warp.
__device__ __forceinline__ void copy_row(int32_t* dst, const int32_t* src, bool al16, int lane) {
  if (al16) {
    cp_async16(dst + LPT * lane, src + LPT * lane);
  } else {
#pragma unroll
    for (int k = 0; k < LPT; ++k) cp_async4(dst + lane + 32 * k, src + lane + 32 * k);
  }
}

// M(f) as (hi, lo) 32-bit halves (see the note above); 0 for f <= 1.
__device__ __forceinline__ uint2 reciprocal(uint32_t f) {
  if (f <= 1) return make_uint2(0, 0);
  uint32_t a = 0xFFFFFFFFu / f;
  uint32_t r = 0xFFFFFFFFu - a * f;  // 2^32 - 1 = a f + r
  if (r + 1 == f) {
    a += 1;
    r = 0;
  } else {
    r += 1;
  }  // now 2^32 = a f + r
  const uint64_t m = (((uint64_t)a << 32) | (r * a + (r * r) / f)) + 1;
  return make_uint2((uint32_t)(m >> 32), (uint32_t)m);
}

// The staged outputs at positions [max(ptr, 0), done) go to the bucket, in
// order, by the whole warp (positions below 0 lie outside the bucket).
template <typename S>
__device__ __forceinline__ void flush_stage(int32_t* __restrict__ out, const S* stage, int mask, int ptr,
                                            int& done, int lane) {
  for (int p = max(ptr, 0) + lane; p < done; p += 32) out[p] = stage[p & mask];
  done = max(ptr, 0);
}

// Warp 0: the state chain and the words. Processing step s codes scan step
// t = T - 1 - s; its row and tokens sit in ring slot s % SLOTS.
__device__ __forceinline__ void encode_words(
    const int32_t* __restrict__ tok, const int32_t* __restrict__ rows, int T, size_t lanes, size_t col,
    int capw, int32_t* __restrict__ wg, uint32_t* __restrict__ states, int32_t* __restrict__ wcount,
    int32_t* smem, int lane) {
  int32_t* rring = smem;
  int32_t* tring = rring + SLOTS * GROUP;
  int32_t* wstage = tring + SLOTS * GROUP;
  uint2* recip = reinterpret_cast<uint2*>(wstage + STAGE_W);
  const unsigned lt = lanemask_lt();
  const bool rows16 = ((uintptr_t)rows & 15) == 0;
  const bool tok16 = ((uintptr_t)tok & 15) == 0;

  auto refill = [&](int c) {
    for (int s = c * CHUNK; s < c * CHUNK + CHUNK && s < T; ++s) {
      const int t = T - 1 - s;
      const int slot = (s & (SLOTS - 1)) * GROUP;
      copy_row(rring + slot, rows + (size_t)t * GROUP, rows16, lane);
      copy_row(tring + slot, tok + (size_t)t * lanes + col, tok16, lane);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < AHEAD; ++i) refill(i);
  for (int f = lane; f <= RANS_M; f += 32) recip[f] = reciprocal((uint32_t)f);

  uint32_t x[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) x[k] = RANS_L;
  int wptr = capw;

  // a step's operands depend only on the ring, not on the state: a chunk's
  // are all loaded before its steps run
  struct Ops { uint32_t f[LPT], cf[LPT]; uint2 mf[LPT]; };
  auto load_ops = [&](int s, Ops& o) {
    const int slot = (s & (SLOTS - 1)) * GROUP;
    const int32_t* row = rring + slot;
    const int4 tk4 = *reinterpret_cast<const int4*>(tring + slot + LPT * lane);
    const int tk[LPT] = {tk4.x, tk4.y, tk4.z, tk4.w};
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      o.f[k] = (uint32_t)row[tk[k]];
      o.cf[k] = (uint32_t)row[tk[k] + 64];
      o.mf[k] = recip[o.f[k]];
    }
  };
  auto step = [&](const Ops& o) {
    int emit[LPT], word[LPT];
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const uint32_t f = o.f[k], xs = x[k];
      emit[k] = (xs >> 20) >= f;
      word[k] = (int)(xs & 0xFFFFu);
      const uint32_t x1 = emit[k] ? (xs >> 16) : xs;
      const uint32_t q = f == 1 ? x1 : (uint32_t)(((uint64_t)x1 * o.mf[k].x + __umulhi(x1, o.mf[k].y)) >> 32);
      x[k] = (q << 12) + (x1 - q * f) + o.cf[k];
    }
    // word ranks, off the state's chain: one ballot per lane position k;
    // the lanes of the threads before this one come first
    int wtot = 0, wpre = 0;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const unsigned bal = __ballot_sync(0xffffffffu, emit[k]);
      wpre += __popc(bal & lt);
      wtot += __popc(bal);
    }
    int wpos = wptr - wtot + wpre;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      if (emit[k]) wstage[wpos & (STAGE_W - 1)] = word[k];
      wpos += emit[k];
    }
    wptr -= wtot;
  };

  int wdone = capw;
  const int n_chunks = (T + CHUNK - 1) / CHUNK;
#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    // the copies of chunk c have landed; the warp's reads of chunk c - 1
    // (and the reciprocal table's stores) are done before refilling, and
    // its staged words are complete before they are written out
    cp_async_wait<AHEAD - 1>();
    __syncwarp();
    flush_stage(wg, wstage, STAGE_W - 1, wptr, wdone, lane);
    refill(c + AHEAD);
    if (c * CHUNK + CHUNK <= T) {
      Ops o[CHUNK];
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) load_ops(c * CHUNK + i, o[i]);
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) step(o[i]);
    } else {
#pragma unroll 1
      for (int s = c * CHUNK; s < T; ++s) {
        Ops o;
        load_ops(s, o);
        step(o);
      }
    }
  }
  cp_async_wait_all();
  __syncwarp();
  flush_stage(wg, wstage, STAGE_W - 1, wptr, wdone, lane);
#pragma unroll
  for (int k = 0; k < LPT; ++k) states[col + LPT * lane + k] = x[k];
  if (lane == 0) *wcount = capw - wptr;
}

// Warp 1: the mantissa bytes, which depend on the tokens alone.
__device__ __forceinline__ void encode_bytes(
    const int32_t* __restrict__ tok, const int32_t* __restrict__ mant, int T, size_t lanes, size_t col,
    int capm, int32_t* __restrict__ mg, int32_t* __restrict__ mcount, int32_t* smem, int lane) {
  int32_t* tring = smem;
  int32_t* mring = tring + SLOTS * GROUP;
  uint8_t* bstage = reinterpret_cast<uint8_t*>(mring + SLOTS * GROUP);
  const unsigned lt = lanemask_lt();
  const bool tok16 = ((uintptr_t)tok & 15) == 0;
  const bool mant16 = ((uintptr_t)mant & 15) == 0;

  auto refill = [&](int c) {
    for (int s = c * CHUNK; s < c * CHUNK + CHUNK && s < T; ++s) {
      const int t = T - 1 - s;
      const int slot = (s & (SLOTS - 1)) * GROUP;
      copy_row(tring + slot, tok + (size_t)t * lanes + col, tok16, lane);
      copy_row(mring + slot, mant + (size_t)t * lanes + col, mant16, lane);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < AHEAD; ++i) refill(i);

  int bptr = capm, bdone = capm;
  const int n_chunks = (T + CHUNK - 1) / CHUNK;
#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<AHEAD - 1>();
    __syncwarp();
    flush_stage(mg, bstage, STAGE_B - 1, bptr, bdone, lane);
    refill(c + AHEAD);
#pragma unroll 1
    for (int s = c * CHUNK; s < c * CHUNK + CHUNK && s < T; ++s) {
      const int slot = (s & (SLOTS - 1)) * GROUP;
      const int4 tk4 = *reinterpret_cast<const int4*>(tring + slot + LPT * lane);
      const int tk[LPT] = {tk4.x, tk4.y, tk4.z, tk4.w};
      int nbyt[LPT], cb = 0;
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        nbyt[k] = tk[k] >= 32 ? (tk[k] - 27 + 7) >> 3 : 0;
        cb += nbyt[k];
      }
      // most steps of a lossy stream carry no mantissa byte: skipped then
      if (!__any_sync(0xffffffffu, cb != 0)) continue;
      const int4 m4 = *reinterpret_cast<const int4*>(mring + slot + LPT * lane);
      const uint32_t m[LPT] = {(uint32_t)m4.x, (uint32_t)m4.y, (uint32_t)m4.z, (uint32_t)m4.w};
      int btot;
      const int bpre = byte_prefix(cb, lt, &btot);
      int bpos = bptr - btot + bpre;
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        // a token carries up to 5 bytes (tokens up to 63), the first 3 of
        // the mantissa: the others stay 0, as in the plain version
#pragma unroll
        for (int j = 0; j < 5; ++j)
          if (j < nbyt[k]) bstage[(bpos + j) & (STAGE_B - 1)] = j < MAX_NBYTES ? (uint8_t)(m[k] >> (8 * j)) : 0;
        bpos += nbyt[k];
      }
      bptr -= btot;
    }
  }
  cp_async_wait_all();
  __syncwarp();
  flush_stage(mg, bstage, STAGE_B - 1, bptr, bdone, lane);
  if (lane == 0) *mcount = capm - bptr;
}

__global__ void __launch_bounds__(64) rans_encode_kernel(
    const int32_t* __restrict__ tok, const int32_t* __restrict__ mant,
    const int32_t* __restrict__ rows, int T, int G, int capw, int capm,
    int32_t* __restrict__ words, int32_t* __restrict__ mbytes,
    uint32_t* __restrict__ states, int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) int32_t smem[];
  const int g = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const size_t lanes = (size_t)G * GROUP;
  const size_t col = (size_t)g * GROUP;
  // the two warps share nothing: each has its own rings and copies
  if (threadIdx.x < 32) {
    encode_words(tok, rows, T, lanes, col, capw, words + (size_t)g * capw, states, counts + g, smem, lane);
  } else {
    encode_bytes(tok, mant, T, lanes, col, capm, mbytes + (size_t)g * capm, counts + G + g, smem + WORDS_SMEM / 4,
                 lane);
  }
}

}  // namespace

// C entry point bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched). words/mbytes must arrive zeroed.
extern "C" int jxl_rans_encode(const void* tok, const void* mant, const void* rows, int T,
                               int G, int capw, int capm, void* words, void* mbytes,
                               void* states, void* counts, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(rans_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  rans_encode_kernel<<<G, 64, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const int32_t*)tok, (const int32_t*)mant, (const int32_t*)rows, T, G, capw, capm,
      (int32_t*)words, (int32_t*)mbytes, (uint32_t*)states, (int32_t*)counts);
  return (int)cudaGetLastError();
}
