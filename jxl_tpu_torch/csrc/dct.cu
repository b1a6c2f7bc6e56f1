// The codec's separable 2-D DCT-II and its inverse over a batch of blocks,
// for Hopper (sm_90a). Kernel D1.
//
// Replaces no TPU kernel: jxl_tpu runs `dct2d` / `idct2d`
// (jxl_tpu/transforms/dct.py) as two batched matmuls that XLA lowers. The
// port ran them as two cuBLAS float32 GEMMs a call, each fed a contiguous
// copy of a permuted view and a basis uploaded from the host; at 12 MP
// they were the largest device item of a round trip. Plain version: the
// CPU branch of jxl_tpu_torch/transforms/dct.py, torch.matmul(torch.matmul(
// Dn, X), Dm^T) and its inverse; the wrapper plans every launch there.
//
// Computes: for each block X [R, Q] of a strided view with up to 8 batch
// dims (sizes and strides as given, no copy), with D_k the [k, k]
// orthonormal DCT-II basis (float32, `_dct_matrix_np(k)`, on the device):
//   two = 1: Y = D_R X D_Q^T (forward) or D_R^T X D_Q (inverse), written as
//            a contiguous [R, Q] block;
//   two = 0: the first factor only, T = D_R X (or D_R^T X), written
//            transposed as a contiguous [Q, R] block. Two such launches,
//            the second over column strips of the first's output, make a
//            transform whose side is above 64 (the 128 and 256 merges).
// The association is the GEMM path's, (D_R X) D_Q^T, every product a
// float32 FMA on the CUDA cores (no tensor core: TF32 is off in the port),
// each output summed over r = 0, 1, ... in that order, so two launches
// give the same bits.
//
// What bounds it on an H100: memory for the small blocks (one read of the
// view and one write of the result: 2 x 146 MB, ~87 us at 3.35 TB/s, for a
// 12 MP frame's three planes), the fp32 FMA rate as the side grows (2 x side
// FMAs a sample: at 64 x 64, 4.7 G FMA a 12 MP frame, ~140 us at 67 TFLOP/s).
//
// The design keeps each block in shared memory from its one read to its
// one write:
//   * a CTA of THREADS threads takes NB consecutive blocks of the batch
//     (NB R Q <= 4096 samples); it computes the blocks' base offsets once
//     (fast division by the batch sizes), then gathers the view's samples
//     with cp.async, all in flight at once, neighbouring threads on
//     neighbouring samples (16 bytes a copy where the view allows it);
//   * a pass contracts the blocks' first axis with a basis held as
//     M^T[r][p] in device memory: a thread owns a tile of up to 4 x 4
//     outputs, and a step r reads one vector of samples from shared memory
//     and one vector of the basis (through L1; the lanes of a warp share
//     one or two) for up to 16 FMAs; it writes its tile transposed, so the
//     second pass contracts the other axis the same way;
//   * a block's rows are packed, blocks one row apart, so the lanes' sample
//     vectors fall on distinct banks across neighbouring blocks;
//   * the result leaves shared memory in the output's order, coalesced.
// Nothing is allocated, nothing synchronises with the host; the launch
// runs on the stream it is given. Measured on an H100 80GB HBM3 at 700 W
// (then the card script, now probes/kernels.py): see PERF.md, kernel D1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_NB = 256;  // blocks a CTA (the wrapper's plan keeps to it)
constexpr int MAXB = 8;      // batch dims

// n / d for n < 2^31 by a multiply and a shift (Granlund-Montgomery).
struct FastDiv {
  unsigned d, magic, shift;
  __device__ __forceinline__ unsigned div(unsigned n) const { return (__umulhi(n, magic) + n) >> shift; }
};

FastDiv make_div(unsigned d) {
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  const unsigned long long m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return FastDiv{d, (unsigned)m, s};
}

struct Params {
  const float* x;
  float* out;
  const float* mr;  // M^T of the first pass, [R, R]
  const float* mq;  // M^T of the second pass, [Q, Q]
  long long row_stride, col_stride;
  long long bstride[MAXB];
  FastDiv bdiv[MAXB];
  FastDiv div_r, div_q, div_rq, div_ra, div_qb;  // by R, Q, R Q, R / A, Q / B
  int nbatch, R, Q, nb, total, two, vec_in, vec_out;
};

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

template <int N>
__device__ __forceinline__ void ldg_vec(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}

// One pass over nb blocks [Rr, Qc] of `in` (rows ld = Qc apart, blocks
// bs_in = (Rr + 1) Qc apart):
//   out[b bs_out + q Rr + p] = sum_r mt[r Rr + p] in[b bs_in + r Qc + q],
// r in order, into blocks [Qc, Rr] bs_out = (Qc + 1) Rr apart. A thread
// owns an RP x RQ tile of outputs (p0.., q0..): a step r reads RQ samples
// and RP basis values, each as one vector, and makes RP RQ FMAs. Lanes run
// over the q tiles first, so a warp's sample reads are neighbouring vectors
// (the block stride's extra row spreads neighbouring blocks over the banks)
// and its basis reads one or two vectors that the lanes share.
template <int RP, int RQ>
__device__ __forceinline__ void contract(const float* __restrict__ in, int Rr, int Qc, int nb, FastDiv div_gq,
                                         FastDiv div_gp, const float* __restrict__ mt, float* __restrict__ out) {
  const int ngq = Qc / RQ, ngp = Rr / RP;
  const int items = nb * ngp * ngq;
  const int bs_in = (Rr + 1) * Qc, bs_out = (Qc + 1) * Rr;
  for (int it = threadIdx.x; it < items; it += THREADS) {
    const unsigned t = div_gq.div(it);
    const int q0 = (it - t * ngq) * RQ;
    const unsigned b = div_gp.div(t);
    const int p0 = (t - b * ngp) * RP;
    const float* src = in + b * bs_in + q0;
    const float* w = mt + p0;
    float acc[RP][RQ];
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int j = 0; j < RQ; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
    for (int r = 0; r < Rr; ++r) {
      float d[RQ], c[RP];
      load_vec<RQ>(src + r * Qc, d);
      ldg_vec<RP>(w + r * Rr, c);
#pragma unroll
      for (int i = 0; i < RP; ++i)
#pragma unroll
        for (int j = 0; j < RQ; ++j) acc[i][j] = fmaf(c[i], d[j], acc[i][j]);
    }
    float* dst = out + b * bs_out + p0;
#pragma unroll
    for (int j = 0; j < RQ; ++j) {
      float col[RP];
#pragma unroll
      for (int i = 0; i < RP; ++i) col[i] = acc[i][j];
      store_vec<RP>(dst + (q0 + j) * Rr, col);
    }
  }
}

// Floats of the X buffer, rounded up to a 16-byte multiple so T starts aligned.
__host__ __device__ __forceinline__ int x_floats(int nb, int R, int Q) { return (nb * (R + 1) * Q + 3) & ~3; }

// A = tile side along R (1, 2 or 4, dividing R), B along Q.
template <int A, int B>
__global__ void __launch_bounds__(THREADS, 4) dct_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ long long base[MAX_NB];
  const int blk0 = blockIdx.x * p.nb;
  const int nb = min(p.nb, p.total - blk0);
  const int R = p.R, Q = p.Q;

  for (int b = threadIdx.x; b < nb; b += THREADS) {
    unsigned idx = blk0 + b;
    long long off = 0;
    for (int d = p.nbatch - 1; d >= 0; --d) {
      const unsigned up = p.bdiv[d].div(idx);
      off += (long long)(idx - up * p.bdiv[d].d) * p.bstride[d];
      idx = up;
    }
    base[b] = off;
  }
  __syncthreads();

  // X (then Y): blocks [R, Q], (R + 1) Q apart; T: blocks [Q, R], (Q + 1) R apart
  float* sx = smem;
  float* st = smem + x_floats(p.nb, R, Q);
  const int n_el = nb * R * Q;
  // sample e of the CTA (block b, row i, column j) lands at e + b Q in X
  if (p.vec_in) {  // four neighbouring samples a copy: Q % 4 == 0, unit column stride, 16-byte aligned
    for (int e = 4 * threadIdx.x; e < n_el; e += 4 * THREADS) {
      const unsigned rho = p.div_q.div(e);
      const int j = e - rho * Q;
      const unsigned b = p.div_r.div(rho);
      const int i = rho - b * R;
      cp_async16(sx + e + b * Q, p.x + base[b] + i * p.row_stride + j);
    }
  } else {
    for (int e = threadIdx.x; e < n_el; e += THREADS) {
      const unsigned rho = p.div_q.div(e);
      const int j = e - rho * Q;
      const unsigned b = p.div_r.div(rho);
      const int i = rho - b * R;
      cp_async4(sx + e + b * Q, p.x + base[b] + i * p.row_stride + j * p.col_stride);
    }
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  contract<A, B>(sx, R, Q, nb, p.div_qb, p.div_ra, p.mr, st);
  __syncthreads();
  const float* z = st;  // blocks [Q, R]
  int zpad = R;
  if (p.two) {
    contract<B, A>(st, Q, R, nb, p.div_ra, p.div_qb, p.mq, sx);
    __syncthreads();
    z = sx;  // blocks [R, Q]
    zpad = Q;
  }

  // output sample e of the CTA lies at e + b zpad in z, b = e / (R Q)
  float* dst = p.out + (long long)blk0 * R * Q;
  if (p.vec_out) {  // R Q % 4 == 0 and zpad % 4 == 0
    for (int e = 4 * threadIdx.x; e < n_el; e += 4 * THREADS) {
      const unsigned b = p.div_rq.div(e);
      *reinterpret_cast<float4*>(dst + e) = *reinterpret_cast<const float4*>(z + e + b * zpad);
    }
  } else {
    for (int e = threadIdx.x; e < n_el; e += THREADS) dst[e] = z[e + p.div_rq.div(e) * zpad];
  }
}

using Kernel = void (*)(const Params);

#define ROW(a) {dct_kernel<a, 1>, dct_kernel<a, 2>, dct_kernel<a, 4>}
const Kernel KERNELS[3][3] = {ROW(1), ROW(2), ROW(4)};
#undef ROW

// index of the tile side in {1, 2, 4}: the largest that divides the side
int tile_index(int side) { return side % 4 == 0 ? 2 : side % 2 == 0 ? 1 : 0; }

}  // namespace

// x: the view's first sample; out: a contiguous float32 result of total x R x Q
// samples; mr, mq: M^T of each pass, [R, R] and [Q, Q] float32 (mq unused
// when two = 0). meta: nbatch, R, Q, row stride, column stride, two, nb, total,
// then (size, stride) of each batch dim, outermost first. The wrapper's plan
// keeps nb <= 256, nbatch <= 8, total < 2^31 and the shared memory under 48 KB.
extern "C" int jxl_dct2d(const void* x, void* out, const void* mr, const void* mq, const long long* meta,
                         void* stream) {
  Params p{};
  p.x = (const float*)x;
  p.out = (float*)out;
  p.mr = (const float*)mr;
  p.mq = (const float*)mq;
  p.nbatch = (int)meta[0];
  p.R = (int)meta[1];
  p.Q = (int)meta[2];
  p.row_stride = meta[3];
  p.col_stride = meta[4];
  p.two = (int)meta[5];
  p.nb = (int)meta[6];
  p.total = (int)meta[7];
  bool aligned = ((uintptr_t)x % 16 == 0) && p.col_stride == 1 && p.Q % 4 == 0 && p.row_stride % 4 == 0;
  for (int d = 0; d < p.nbatch; ++d) {
    p.bdiv[d] = make_div((unsigned)meta[8 + 2 * d]);
    p.bstride[d] = meta[9 + 2 * d];
    aligned = aligned && p.bstride[d] % 4 == 0;
  }
  p.vec_in = aligned;
  const int ta = tile_index(p.R), tb = tile_index(p.Q);
  const int A = 1 << ta, B = 1 << tb;
  p.div_r = make_div((unsigned)p.R);
  p.div_q = make_div((unsigned)p.Q);
  p.div_rq = make_div((unsigned)(p.R * p.Q));
  p.div_ra = make_div((unsigned)(p.R / A));
  p.div_qb = make_div((unsigned)(p.Q / B));
  p.vec_out = (p.R * p.Q) % 4 == 0 && (p.two ? p.Q : p.R) % 4 == 0;
  const size_t smem = sizeof(float) * ((size_t)x_floats(p.nb, p.R, p.Q) + (size_t)p.nb * (p.Q + 1) * p.R);
  const unsigned grid = (unsigned)((p.total + p.nb - 1) / p.nb);
  KERNELS[ta][tb]<<<grid, THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
