// Fused blind rotate (the whole CMux chain) over the COMPACT F-block key, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU route torus_fhe_tpu/ops/fblock.py::
// blind_rotate_streamed(use_pallas=True): XLA expansion of each 64-step chunk
// of compact lines (expand_fblock_chunk), then the Pallas kernel
// (pallas_rotate.py:264) on the chunk. It is the 3gen multikey rotate at 4 and
// 8 parties (mk/boot3gen.py::_fast_rotate_extract). Bit-identical to the plain
// version torus_fhe_tpu_torch/ops/fblock.py::blind_rotate_streamed and to
// blind_rotate.cu over the expanded key.
//
// The key is sel (steps, R, 2N, ncols) int8, as fblock.build_sel lays it out,
// read as it is: per step, R extended lines ext_r = [k_r, -k_r] of 2N
// coefficients, split into ncols byte-limb columns. Entry (u, t) of the
// expanded F-block matrix of line r, column ci is ext_r[(t - u) mod 2N][ci],
// so one step's whole key is R*2N*ncols bytes (64 KB at the 2-party 3gen set,
// 128 KB at 8 parties) against the expanded D*R*bs*ncols*bs (8.4-16.8 MB). No
// expanded copy exists anywhere.
//
// What bounds it on this card: int8 multiply-accumulates. Per gate and step,
// ncols*N outputs each sum R*N products (67 M MACs at 8 parties), on __dp4a.
// The key crosses from device memory (or L2, shared by the blocks on the
// same step) once per block and step, ~1% of the step's time. Design:
//  - one block per tile of BT gates, with its accumulators (C*N uint32 per
//    gate), four byte-shifted copies of its digit rows and the step's lines in
//    dynamic shared memory;
//  - each step the block stages the step's lines reversed and column-major:
//    key[ci][r][g] = ext_r[(-g) mod 2N][ci];
//  - the digit rows are stored four times, shifted by j = 0..3 bytes:
//    dig[j][r][v + 4] = digit_r[v + j], zero outside [0, N). Output t = 4q + j
//    is then the sum over aligned words v = -4, 0, .., N-4 of
//    __dp4a(key word at g = v - 4q, dig[j] word at v): every load is an
//    aligned 4-byte word, and no byte shuffle runs in the inner loop;
//  - a thread owns KQ = 2 output quads x CG = 4 limb columns x BT gates of
//    sums; lanes of a warp take consecutive quads, so their key words fall in
//    distinct banks, and the digit words are one broadcast;
//  - the shift-add of each sum into acc is a shared-memory atomicAdd (exact
//    mod 2^32).
// The sums are exact: R*N products of |digit| <= 2^(lb-1) and |limb| <= 128,
// below 2^31 (checked by the wrapper; 2^23 at 8 parties, 2^25 at 2).
// Not used yet: the tensor cores (wgmma), TMA, clusters, and overlap of the
// next step's key load with this step's sums.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cmux_step.cuh"

#define SEL_MAX_COLS 32
#define SEL_THREADS 256
#define KQ 2  // output quads per thread
#define CG 4  // limb columns per thread

struct SelGeom {
  int steps, N, C, R, l, lb, ncols;
  uint32_t offset, mu;
  int col_poly[SEL_MAX_COLS];
  int col_shift[SEL_MAX_COLS];
};

template <int BT>
__global__ void __launch_bounds__(SEL_THREADS) blind_rotate_sel_kernel(
    int32_t* __restrict__ out, const int32_t* __restrict__ acc_in,
    const int32_t* __restrict__ barb, const int32_t* __restrict__ bara,
    const int8_t* __restrict__ sel, int B, SelGeom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = g.N, C = g.C, R = g.R, ncols = g.ncols;
  const int CN = C * N, twoN = 2 * N;
  const int drow = N + 4;          // bytes of one shifted digit row
  const int dshift = R * drow;     // bytes between two shifts j of one gate
  const int dgate = 4 * dshift;    // digit bytes per gate
  uint32_t* acc = reinterpret_cast<uint32_t*>(smem);                    // [BT][C][N]
  int8_t* dig = reinterpret_cast<int8_t*>(smem + (size_t)BT * CN * 4);  // [BT][4][R][N+4]
  int8_t* key = dig + (size_t)BT * dgate;                               // [ncols][R][2N]
  const int gate0 = blockIdx.x * BT;
  const int tid = threadIdx.x;

  // initial accumulator; gates past B (the ragged last tile) run on zeros
  for (int e = tid; e < BT * CN; e += SEL_THREADS) {
    const int gi = e / CN, gate = gate0 + gi;
    acc[e] = gate < B ? init_acc_word(acc_in, barb, gate, e - gi * CN, N, C, g.mu) : 0u;
  }
  // the digit bytes outside [0, N) of each shifted row stay zero for all steps
  for (int e = tid; e < BT * dgate / 4; e += SEL_THREADS)
    reinterpret_cast<uint32_t*>(dig)[e] = 0u;
  __syncthreads();

  const size_t step_bytes = (size_t)R * twoN * ncols;
  const int nq = N / 4;                  // output quads per polynomial
  const int qspan = nq / KQ;             // quads between a thread's KQ quads
  const int items = (ncols + CG - 1) / CG * qspan;
  const int wmask = N / 2 - 1;           // key words per line, minus one
  const uint32_t lmask = (1u << g.lb) - 1u, half = 1u << (g.lb - 1);

  for (int s = 0; s < g.steps; ++s) {
    // stage the step's lines: key[ci][r][g] = sel[s][r][(-g) mod 2N][ci]
    const int8_t* ks = sel + (size_t)s * step_bytes;
    for (int e = tid; e < R * twoN; e += SEL_THREADS) {
      const int r = e / twoN, f = e - r * twoN;
      int8_t* dst = key + (size_t)r * twoN + ((twoN - f) & (twoN - 1));
      const int8_t* src = ks + (size_t)e * ncols;
      for (int ci = 0; ci < ncols; ++ci) dst[(size_t)ci * R * twoN] = __ldg(src + ci);
    }
    // rotate by index, difference, decompose into the four shifted digit rows
    for (int e = tid; e < BT * CN; e += SEL_THREADS) {
      const int gi = e / CN, rem = e - gi * CN;
      const int c = rem / N, t = rem - c * N;
      const int gate = gate0 + gi;
      const int a = gate < B ? (bara[(size_t)gate * g.steps + s] & (twoN - 1)) : 0;
      const uint32_t x = cmux_diff(acc + gi * CN + c * N, t, a, N, g.offset);
      int8_t* d = dig + (size_t)gi * dgate + c * drow + t + 4;
      for (int lev = 0; lev < g.l; ++lev) {
        const int8_t v = gadget_digit(x, 32 - (lev + 1) * g.lb, lmask, half);
        int8_t* dl = d + lev * C * drow;  // row r = lev*C + c
#pragma unroll
        for (int j = 0; j < 4; ++j) dl[j * dshift - j] = v;
      }
    }
    __syncthreads();

    // contract: item = (column group cg, quad q0); the thread's quads are
    // q0 + k*qspan, its columns cg*CG .. cg*CG + CG-1
    for (int it = tid; it < items; it += SEL_THREADS) {
      const int cg = it / qspan, q0 = it - cg * qspan;
      int sum[BT][KQ][CG][4];
#pragma unroll
      for (int gi = 0; gi < BT; ++gi)
#pragma unroll
        for (int k = 0; k < KQ; ++k)
#pragma unroll
          for (int cc = 0; cc < CG; ++cc)
#pragma unroll
            for (int j = 0; j < 4; ++j) sum[gi][k][cc][j] = 0;
      for (int r = 0; r < R; ++r) {
        const uint32_t* krow[CG];
#pragma unroll
        for (int cc = 0; cc < CG; ++cc) {
          const int ci = min(cg * CG + cc, ncols - 1);  // a ragged group repeats a column
          krow[cc] = reinterpret_cast<const uint32_t*>(key + ((size_t)ci * R + r) * twoN);
        }
        const uint32_t* drp = reinterpret_cast<const uint32_t*>(dig + r * drow);
#pragma unroll 2
        for (int vw = 0; vw <= nq; ++vw) {  // word vw holds v = 4*(vw-1) .. +3
          uint32_t dw[BT][4];
#pragma unroll
          for (int gi = 0; gi < BT; ++gi)
#pragma unroll
            for (int j = 0; j < 4; ++j) dw[gi][j] = drp[(gi * dgate + j * dshift) / 4 + vw];
#pragma unroll
          for (int k = 0; k < KQ; ++k) {
            const int kw = (vw - 1 - (q0 + k * qspan)) & wmask;
#pragma unroll
            for (int cc = 0; cc < CG; ++cc) {
              const int w = (int)krow[cc][kw];
#pragma unroll
              for (int gi = 0; gi < BT; ++gi)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  sum[gi][k][cc][j] = __dp4a(w, (int)dw[gi][j], sum[gi][k][cc][j]);
            }
          }
        }
      }
#pragma unroll
      for (int cc = 0; cc < CG; ++cc) {
        const int ci = cg * CG + cc;
        if (ci < ncols) {
          const int shift = g.col_shift[ci];
          uint32_t* dst = acc + g.col_poly[ci] * N;
#pragma unroll
          for (int gi = 0; gi < BT; ++gi)
#pragma unroll
            for (int k = 0; k < KQ; ++k)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                atomicAdd(dst + gi * CN + 4 * (q0 + k * qspan) + j,
                          (uint32_t)sum[gi][k][cc][j] << shift);
        }
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < BT * CN; e += SEL_THREADS) {
    const int gi = e / CN;
    if (gate0 + gi < B) out[(size_t)(gate0 + gi) * CN + (e - gi * CN)] = (int32_t)acc[e];
  }
}

template <int BT>
static cudaError_t launch_sel(int32_t* out, const int32_t* acc_in, const int32_t* barb,
                              const int32_t* bara, const int8_t* sel, int B,
                              const SelGeom& g, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate_sel_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + BT - 1) / BT;
  blind_rotate_sel_kernel<BT><<<blocks, SEL_THREADS, smem, stream>>>(out, acc_in, barb, bara,
                                                                     sel, B, g);
  return cudaGetLastError();
}

// acc_in == NULL selects the stepvec mode (barb and mu); otherwise barb is
// unused. bt is the tile of gates per block, one of 1, 2, 4; its shared
// memory is bt * (C*N*4 accumulator + 4*R*(N+4) digit) + ncols*R*2N key bytes.
// Returns the CUDA error of the launch (0 on success).
extern "C" int blind_rotate_sel_launch(void* out, const void* acc_in, const void* barb,
                                       const void* bara, const void* sel, int B, int bt,
                                       int steps, int N, int C, int l, int lb,
                                       unsigned int offset, unsigned int mu, int ncols,
                                       const int* col_poly, const int* col_shift,
                                       void* stream) {
  if (ncols > SEL_MAX_COLS || N % 8) return (int)cudaErrorInvalidValue;
  SelGeom g;
  g.steps = steps; g.N = N; g.C = C; g.R = l * C; g.l = l; g.lb = lb; g.ncols = ncols;
  g.offset = offset; g.mu = mu;
  for (int i = 0; i < SEL_MAX_COLS; ++i) {
    g.col_poly[i] = i < ncols ? col_poly[i] : 0;
    g.col_shift[i] = i < ncols ? col_shift[i] : 0;
  }
  const size_t smem = (size_t)bt * (C * N * 4 + 4 * g.R * (N + 4)) + (size_t)ncols * g.R * 2 * N;
  auto o = static_cast<int32_t*>(out);
  auto ai = static_cast<const int32_t*>(acc_in);
  auto bb = static_cast<const int32_t*>(barb);
  auto ba = static_cast<const int32_t*>(bara);
  auto sp = static_cast<const int8_t*>(sel);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bt) {
    case 1: err = launch_sel<1>(o, ai, bb, ba, sp, B, g, smem, st); break;
    case 2: err = launch_sel<2>(o, ai, bb, ba, sp, B, g, smem, st); break;
    case 4: err = launch_sel<4>(o, ai, bb, ba, sp, B, g, smem, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
