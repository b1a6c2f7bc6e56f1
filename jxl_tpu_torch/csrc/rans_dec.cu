// Grouped, interleaved rANS decode scan for Hopper (sm_90a), over one
// stream or a batch of same-geometry streams.
//
// Replaces the Pallas TPU kernels `decode_grouped_pallas` (B1) and
// `decode_grouped_pallas_batched` (B2) (jxl_tpu/entropy/pallas_rans.py,
// kernel body `_make_kernel(G, B)`). Plain versions:
// jxl_tpu_torch/entropy/grouped.py:decode_grouped and
// decode_grouped_batched, bit for bit.
//
// What bounds it on an H100: the scan is a chain of T dependent steps per
// 128-lane group, and one stream at the bench shape (lanes 256, T 4731) is
// only G = 2 groups, so the card is idle but for two SMs. The roofline
// bound (each input byte read once, each output written once, at
// 3.35 TB/s) is 2.2 us; the chain bound, T times the latency of what a
// step must do in order (a one-load symbol lookup, the multiply-add, the
// renormalise test and its rank, the read of the ranked word, the merge),
// is 0.341 ms: 142.7 SM cycles a step, measured on the card by
// csrc/chain_probe.cu (a shared load 23.0 cycles, a ballot-popcount-add
// 50.0; jxl_tpu_torch/entropy/kernel_bounds.py makes the bounds). Measured
// on an H100 80GB HBM3 at 700 W, SM clock 1980 MHz, in turns with the
// previous design (then probes/rans_kernels.py, now probes/kernels.py
// --parent-csrc): 1.820 ms for both phases, 762 cycles a step, 18.7%
// of the chain bound; the previous design (four warps, one lane a
// thread, the word and byte windows loaded from device memory at pointers
// the previous step had just computed, two block barriers a step) took
// 2.614 ms. Its step clock splits warp 0's step
// (cycles, clock reads included): the symbol search 317 (row loads 41,
// probes 32/16/8 109, probes 4/2/1 167), the multiply-add and test 83,
// the word ranks 98, the word reads and merge 201, the symbol store 25,
// and 198 of chunk-loop work (waits, refills, the hand-over) a step.
//
// The design keeps device memory and block barriers off the chain. Each
// CTA is two warps for one (stream b, group g):
//   * warp 0 owns the states, thread j lanes 4j..4j+3, so lane order is
//     thread order and the word rank is a warp operation: one ballot per
//     lane position k, rank(4j + k) = sum_k' popc(ballot_k' & lanemask_lt)
//     + the thread's own lanes before k. Per step it runs the plain
//     version's 6-probe binary search (probes 32, 16, 8 select among the
//     7 cum values at multiples of 8, read once for all lanes; probes 4, 2,
//     1 read the row, the four lanes' probes side by side), the
//     multiply-add, the renormalise ranks and the word reads, and writes
//     the step's 128 symbols (one byte each) to a symbol ring;
//   * warp 1 turns the symbols into values: the mantissa bytes, ranked
//     the same way (the exclusive warp prefix of the threads' byte counts
//     from ballots of their 5 bit planes), the detokenised values and one
//     16-byte store per thread and step. It is off warp 0's chain
//     entirely: most steps of a lossy stream carry no byte, and a dense
//     stream's bytes no longer slow the states;
//   * the two warps hand the symbol ring over chunk by chunk (CHUNK steps,
//     NSYM chunks in the ring) through mbarriers, a full and an empty
//     barrier per chunk slot: the only waits are at chunk boundaries;
//   * rings in shared memory, refilled ahead with cp.async by the warp that
//     reads them: the step rows and the word stream (warp 0), the mantissa
//     bytes (warp 1, one int32 each). At the start of chunk c a warp waits
//     for its copies of chunk c, crosses one __syncwarp, and starts the
//     copies of the rows of chunk c + AHEAD and a top-up of its stream ring
//     to its pointer + ring size. The copies it waits for were started at
//     the start of chunk c - AHEAD and reach that chunk's pointer + ring
//     size; chunks c - AHEAD..c consume at most (AHEAD + 1) * CHUNK steps
//     of 128 words or of 5 bytes a lane (a symbol up to 63, as a corrupt
//     row may hold), which the static_asserts hold the rings to, so all a
//     step reads has landed. Elements past a bucket's end (or before its
//     start) are stored as 0 instead of copied: reads past the end read 0.
// B2 is the same body with one CTA per (stream, group): a batch fills the
// card instead of lengthening the chain, and runs at B1's pace per stream.
//
// Shared memory per CTA: (ROW_SLOTS * 128 + WRING + BRING) * 4 + the
// symbol ring and barriers = 102,464 B (dynamic; the attribute is set
// before each launch). ptxas: 48 registers, no spills (probes/kernels.py
// prints it).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int GROUP = 128;
constexpr int LPT = 4;  // lanes per thread
constexpr int MAX_NBYTES = 3;  // mantissa bytes read per token
constexpr int MAX_STEP_BYTES = 5;  // bytes a lane's symbol can consume (symbols up to 63 in a row)
constexpr uint32_t RANS_L = 1u << 16;
constexpr uint32_t SLOT_MASK = (1u << 12) - 1u;

constexpr int CHUNK = 8;   // steps per ring chunk
constexpr int AHEAD = 2;   // chunks in flight ahead of the one decoded
constexpr int ROW_SLOTS = 32;
constexpr int WRING = 4096;
constexpr int BRING = 16384;
static_assert(ROW_SLOTS >= (AHEAD + 1) * CHUNK, "row ring too small");
static_assert(WRING >= (AHEAD + 1) * CHUNK * GROUP, "word ring too small");
static_assert(BRING >= (AHEAD + 1) * CHUNK * MAX_STEP_BYTES * GROUP, "byte ring too small");
constexpr int NSYM = 4;  // chunks of decoded symbols between the two warps
constexpr int SMEM_BYTES = (ROW_SLOTS * GROUP + WRING + BRING) * 4 + NSYM * CHUNK * GROUP + 2 * NSYM * 8;

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

// One 128-int32 row from device memory into a shared slot, by the warp.
__device__ __forceinline__ void copy_row(int32_t* dst, const int32_t* src, bool al16, int lane) {
  if (al16) {
    cp_async16(dst + LPT * lane, src + LPT * lane);
  } else {
#pragma unroll
    for (int k = 0; k < LPT; ++k) cp_async4(dst + lane + 32 * k, src + lane + 32 * k);
  }
}

// Ring positions [from, to) of a stream (absolute element indices) from
// device memory; indices outside [0, cap) are stored as 0.
__device__ __forceinline__ void top_up(int32_t* ring, int mask, const int32_t* src, int cap, int from,
                                       int to, int lane) {
  for (int i = from + lane; i < to; i += 32) {
    int32_t* d = ring + (i & mask);
    if (i >= 0 && i < cap) {
      cp_async4(d, src + i);
    } else {
      *d = 0;
    }
  }
}

// v[2 i + 1] for i in 0..3, by selects
__device__ __forceinline__ int sel_odd(const int v[8], int i) {
  const int lo = (i & 1) ? v[3] : v[1], hi = (i & 1) ? v[7] : v[5];
  return (i & 2) ? hi : lo;
}

// mbarriers in shared memory, for the hand-over between the two warps
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared.b64 st, [%0];\n}\n" ::"r"(smem_addr(bar)) : "memory");
}
// Waits until the phase of parity `parity` has completed. A barrier that
// never completes (a fault) traps after ~2^28 polls instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (unsigned polls = 0;; ++polls) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (polls > (1u << 28)) __trap();
  }
}

// Warp 0: the states. Per step the symbol search, the state update and the
// word reads; the step's symbols go to the symbol ring (4 per thread, one
// byte each), chunk by chunk, for warp 1.
__device__ __forceinline__ void decode_states(
    const int32_t* __restrict__ wg, int capw, const int32_t* __restrict__ rb, size_t row_stride, int T,
    const uint32_t* __restrict__ st_in, uint32_t* __restrict__ st_out, int gptr, int32_t* __restrict__ gptr_out,
    int32_t* rring, int32_t* wring, uint32_t* symring, uint64_t* full, uint64_t* empty, int lane) {
  const unsigned lt = lanemask_lt();
  const bool rows16 = ((uintptr_t)rb & 15) == 0;
  uint32_t x[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) x[k] = st_in[LPT * lane + k];

  int wload = gptr;  // the word ring is topped up to here
  auto refill = [&](int c) {  // rows of chunk c, the word top-up; one commit group
    for (int t = c * CHUNK; t < c * CHUNK + CHUNK && t < T; ++t)
      copy_row(rring + (t & (ROW_SLOTS - 1)) * GROUP, rb + (size_t)t * row_stride, rows16, lane);
    const int wto = gptr + WRING;
    top_up(wring, WRING - 1, wg, capw, max(wload, gptr), wto, lane);
    wload = wto;
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < AHEAD; ++i) refill(i);

  // one scan step t
  auto step = [&](int t, uint32_t* symdst) {
    const int32_t* row = rring + (t & (ROW_SLOTS - 1)) * GROUP;
    const int32_t* cum = row + 64;
    int c8[8];
#pragma unroll
    for (int j = 1; j < 8; ++j) c8[j] = cum[8 * j];

    // the plain version's 6-probe binary search, one probe level at a time
    // for the thread's four lanes (four independent chains in flight):
    // probes 32, 16, 8 select among the cum values at multiples of 8 (the
    // same for every lane, read once), probes 4, 2, 1 read the row
    int sym[LPT], slot[LPT];
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      slot[k] = (int)(x[k] & SLOT_MASK);
      sym[k] = c8[4] <= slot[k] ? 32 : 0;
    }
#pragma unroll
    for (int k = 0; k < LPT; ++k) sym[k] += ((sym[k] ? c8[6] : c8[2]) <= slot[k]) ? 16 : 0;
#pragma unroll
    for (int k = 0; k < LPT; ++k) sym[k] += (sel_odd(c8, sym[k] >> 4) <= slot[k]) ? 8 : 0;
#pragma unroll
    for (int p = 4; p >= 1; p >>= 1) {
#pragma unroll
      for (int k = 0; k < LPT; ++k) sym[k] += cum[sym[k] + p] <= slot[k] ? p : 0;
    }

    uint32_t xd[LPT];
    int need[LPT];
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      xd[k] = (uint32_t)row[sym[k]] * (x[k] >> 12) + (uint32_t)(slot[k] - cum[sym[k]]);
      need[k] = xd[k] < RANS_L;
    }
    // word ranks: one ballot per lane position k; the lanes of the threads
    // before this one come first, then this thread's lanes before k
    int wpre = 0, wtot = 0;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const unsigned bal = __ballot_sync(0xffffffffu, need[k]);
      wpre += __popc(bal & lt);
      wtot += __popc(bal);
    }
    // unconditional ring reads (a lane that needs none reads a slot it
    // ignores): the step has no branch
    int wpos = gptr + wpre;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const int32_t w = wring[wpos & (WRING - 1)];
      x[k] = need[k] ? (xd[k] << 16) | (uint32_t)w : xd[k];
      wpos += need[k];
    }
    gptr += wtot;
    symdst[lane] = (uint32_t)sym[0] | (uint32_t)sym[1] << 8 | (uint32_t)sym[2] << 16 | (uint32_t)sym[3] << 24;
  };

  const int n_chunks = (T + CHUNK - 1) / CHUNK;
#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    // the copies of chunk c have landed (AHEAD - 1 younger groups may
    // still fly); the warp's reads of chunk c - 1 are done before its
    // slots are refilled
    cp_async_wait<AHEAD - 1>();
    __syncwarp();
    refill(c + AHEAD);
    // symbol slot c % NSYM is free once warp 1 has read chunk c - NSYM
    const int s = c % NSYM;
    if (c >= NSYM) mbar_wait(&empty[s], (c / NSYM - 1) & 1);
#pragma unroll 1
    for (int t = c * CHUNK; t < c * CHUNK + CHUNK && t < T; ++t)
      step(t, symring + (s * CHUNK + t - c * CHUNK) * 32);
    mbar_arrive(&full[s]);
  }
  cp_async_wait_all();
#pragma unroll
  for (int k = 0; k < LPT; ++k) st_out[LPT * lane + k] = x[k];
  if (lane == 0) *gptr_out = gptr;
}

// Warp 1: the values. Per step the mantissa bytes of the symbols warp 0
// decoded (ranked as the words are), the detokenised values and their
// store; the byte ring is this warp's own.
__device__ __forceinline__ void decode_values(
    const int32_t* __restrict__ mg, int capm, int T, size_t lanes, int32_t* __restrict__ vb, int bptr,
    int32_t* __restrict__ bptr_out, int32_t* bring, const uint32_t* symring, uint64_t* full, uint64_t* empty,
    int lane) {
  const unsigned lt = lanemask_lt();
  int bload = bptr;  // the byte ring is topped up to here
  auto refill = [&]() {
    const int bto = bptr + BRING;
    top_up(bring, BRING - 1, mg, capm, max(bload, bptr), bto, lane);
    bload = bto;
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < AHEAD; ++i) refill();

  const int n_chunks = (T + CHUNK - 1) / CHUNK;
#pragma unroll 1
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<AHEAD - 1>();
    __syncwarp();
    refill();
    const int s = c % NSYM;
    mbar_wait(&full[s], (c / NSYM) & 1);
#pragma unroll 1
    for (int t = c * CHUNK; t < c * CHUNK + CHUNK && t < T; ++t) {
      const uint32_t packed = symring[(s * CHUNK + t - c * CHUNK) * 32 + lane];
      int sym[LPT], nbits[LPT], nbyt[LPT], out[LPT];
      int cbt = 0;
#pragma unroll
      for (int k = 0; k < LPT; ++k) {
        sym[k] = (int)((packed >> (8 * k)) & 0xFFu);
        nbits[k] = sym[k] >= 32 ? sym[k] - 27 : 0;
        nbyt[k] = (nbits[k] + 7) >> 3;
        cbt += nbyt[k];
        out[k] = sym[k];  // a symbol below 32 is its value (and carries no byte)
      }
      // most steps of a lossy stream carry no mantissa byte at all
      if (__any_sync(0xffffffffu, cbt != 0)) {
        int btot;
        const int bpre = byte_prefix(cbt, lt, &btot);
        int bpos = bptr + bpre;
#pragma unroll
        for (int k = 0; k < LPT; ++k) {
          uint32_t mval = 0;
#pragma unroll
          for (int j = 0; j < MAX_NBYTES; ++j) {
            const uint32_t m = (uint32_t)bring[(bpos + j) & (BRING - 1)];
            mval |= j < nbyt[k] ? m << (8 * j) : 0u;
          }
          bpos += nbyt[k];
          const uint32_t lead = nbits[k] < 32 ? 1u << nbits[k] : 0u;
          if (sym[k] >= 32) out[k] = (int32_t)(lead + mval);
        }
        bptr += btot;
      }
      *reinterpret_cast<int4*>(vb + (size_t)t * lanes) = make_int4(out[0], out[1], out[2], out[3]);
    }
    mbar_arrive(&empty[s]);
  }
  cp_async_wait_all();
  if (lane == 0) *bptr_out = bptr;
}

__global__ void __launch_bounds__(64) rans_decode_kernel(
    const int32_t* __restrict__ words, int capw,
    const int32_t* __restrict__ mant, int capm,
    const int32_t* __restrict__ rows, int T,
    const uint32_t* __restrict__ states_in, const int32_t* __restrict__ ptrs_in,
    int G, int B, int32_t* __restrict__ values, uint32_t* __restrict__ states_out,
    int32_t* __restrict__ ptrs_out) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* rring = smem;
  int32_t* wring = rring + ROW_SLOTS * GROUP;
  int32_t* bring = wring + WRING;
  uint32_t* symring = reinterpret_cast<uint32_t*>(bring + BRING);
  uint64_t* full = reinterpret_cast<uint64_t*>(symring + NSYM * CHUNK * 32);
  uint64_t* empty = full + NSYM;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NSYM; ++i) {
      mbar_init(&full[i], 32);
      mbar_init(&empty[i], 32);
    }
  }
  __syncthreads();  // once, before the scans: the barriers are initialised

  // block n = b * G + g: group g of stream b; its words, bytes, states and
  // pointers are row n of the stacked [B * G, ...] buffers
  const int n = blockIdx.x;
  const int b = n / G;
  const int g = n - b * G;
  const int NG = B * G;
  const int lane = threadIdx.x & 31;
  const size_t lanes = (size_t)G * GROUP;
  if (threadIdx.x < 32) {
    // rows [T, B, 128]: step t of stream b at (t * B + b) * 128
    decode_states(words + (size_t)n * capw, capw, rows + (size_t)b * GROUP, (size_t)B * GROUP, T,
                  states_in + (size_t)n * GROUP, states_out + (size_t)n * GROUP, ptrs_in[n], ptrs_out + n, rring,
                  wring, symring, full, empty, lane);
  } else {
    decode_values(mant + (size_t)n * capm, capm, T, lanes,
                  values + (size_t)b * T * lanes + (size_t)g * GROUP + LPT * lane, ptrs_in[NG + n],
                  ptrs_out + NG + n, bring, symring, full, empty, lane);
  }
}

int launch(const void* words, int capw, const void* mant, int capm, const void* rows, int T,
           const void* states_in, const void* ptrs_in, int G, int B, void* values,
           void* states_out, void* ptrs_out, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(rans_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  rans_decode_kernel<<<B * G, 64, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const int32_t*)words, capw, (const int32_t*)mant, capm, (const int32_t*)rows, T,
      (const uint32_t*)states_in, (const int32_t*)ptrs_in, G, B, (int32_t*)values,
      (uint32_t*)states_out, (int32_t*)ptrs_out);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points bound with ctypes. Each launches on `stream` and returns
// cudaGetLastError() (0 = launched).

// B1: one stream. words [G, capw], states [G * 128], rows [T, 128],
// ptrs [2, G], values [T * G * 128].
extern "C" int jxl_rans_decode(const void* words, int capw, const void* mant, int capm,
                               const void* rows, int T, const void* states_in,
                               const void* ptrs_in, int G, void* values,
                               void* states_out, void* ptrs_out, void* stream) {
  return launch(words, capw, mant, capm, rows, T, states_in, ptrs_in, G, 1, values,
                states_out, ptrs_out, stream);
}

// B2: B streams. words [B * G, capw], states [B, G * 128], rows [T, B, 128],
// ptrs [2, B * G], values [B, T * G * 128].
extern "C" int jxl_rans_decode_batched(const void* words, int capw, const void* mant,
                                       int capm, const void* rows, int T,
                                       const void* states_in, const void* ptrs_in, int G,
                                       int B, void* values, void* states_out,
                                       void* ptrs_out, void* stream) {
  return launch(words, capw, mant, capm, rows, T, states_in, ptrs_in, G, B, values,
                states_out, ptrs_out, stream);
}
