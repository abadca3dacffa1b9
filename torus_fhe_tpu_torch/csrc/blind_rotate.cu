// Fused blind rotate (the whole n-step CMux chain) over the F-block
// bootstrapping key, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel torus_fhe_tpu/ops/pallas_rotate.py
// (_rotate_kernel via blind_rotate_pallas), in both of its init modes:
// an explicit (B, C, N) accumulator, or the gate test vector built in-kernel
// from barb ("stepvec"). The result is bit-identical to it and to the plain
// PyTorch version, torus_fhe_tpu_torch/ops/fblock.py::blind_rotate_fblock.
//
// What bounds it on this card: int8 multiply-accumulates (10.9 GMAC per gate
// at tfhe_128_tpu_fast: 630 steps x 4 output blocks x 3072 x 1408) and the
// key stream (5.45 GB per pass over the 630 steps). This first design is
// simple: one block per tile of BT gates, the accumulators of its gates in
// dynamic shared memory for all n steps (as the TPU kept them in VMEM), and
// the contraction on __dp4a (four int8 products into an int32 per
// instruction). Every block re-reads each step's key slice (8.65 MB at the
// fast set) from global memory, relying on the 50 MB L2 to serve the blocks
// that are on the same step; the tensor cores (wgmma), TMA and clusters are
// not used yet.
//
// Per step s, for each gate of the tile:
//   1. rot[c][t] = (X^a * acc[c])[t], a = bara[s] & (2N-1), by index;
//   2. x = rot - acc + offset (uint32: torus words wrap mod 2^32);
//   3. l int8 digit rows: ((x >> (32 - (lev+1)*lb)) & (Bg-1)) - Bg/2,
//      stored as row r = lev*C + c of digit block i = t / bs;
//   4. output block j, limb column ci, coefficient q:
//      sum over (i, r, p) of digit[i][r][p] * fb[s][m*R*bs + r*bs + p][ci*bs + q],
//      m = (i - j) mod D (the key's seq_perm order), exact in int32;
//   5. acc[poly(ci)][j*bs + q] += sum << shift(ci).
// The sums are exact: each output sums K = nb*R*bs = R*N products of
// |digit| <= 2^(lb-1) and |limb| <= 128, so R*N*2^(lb-1)*128 < 2^31 bounds it
// (the wrapper checks this; 2^25 at the 2-party 3gen set).
// Steps 1-3 and the stepvec init are shared with blind_rotate_sel.cu
// (cmux_step.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cmux_step.cuh"

#define MAX_COLS 32
#define THREADS 256

struct Geom {
  int n, N, bs, nb, D, C, R, l, lb, ncols;
  uint32_t offset, mu;
  int col_poly[MAX_COLS];
  int col_shift[MAX_COLS];
};

// 4x4 byte transpose: w[u] holds columns 0..3 of key row u; v[c] gets rows
// 0..3 of column c, the byte order __dp4a pairs with four consecutive digits.
__device__ __forceinline__ void transpose4(const uint32_t w[4], uint32_t v[4]) {
  uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
  uint32_t t1 = __byte_perm(w[0], w[1], 0x7362);
  uint32_t t2 = __byte_perm(w[2], w[3], 0x5140);
  uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
  v[0] = __byte_perm(t0, t2, 0x5410);
  v[1] = __byte_perm(t0, t2, 0x7632);
  v[2] = __byte_perm(t1, t3, 0x5410);
  v[3] = __byte_perm(t1, t3, 0x7632);
}

template <int BT>
__global__ void __launch_bounds__(THREADS) blind_rotate_kernel(
    int32_t* __restrict__ out, const int32_t* __restrict__ acc_in,
    const int32_t* __restrict__ barb, const int32_t* __restrict__ bara,
    const int8_t* __restrict__ fb, int B, Geom g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = g.N, C = g.C, bs = g.bs;
  const int CN = C * N;
  const int Rbs = g.R * bs;
  const int K = g.nb * Rbs;  // digit bytes per gate
  uint32_t* acc = reinterpret_cast<uint32_t*>(smem);                 // [BT][C][N]
  int8_t* dig = reinterpret_cast<int8_t*>(smem + (size_t)BT * CN * 4);  // [BT][nb][R][bs]
  const int gate0 = blockIdx.x * BT;
  const int tid = threadIdx.x;

  // initial accumulator; gates past B (the ragged last tile) run on zeros
  for (int e = tid; e < BT * CN; e += THREADS) {
    const int gi = e / CN, gate = gate0 + gi;
    acc[e] = gate < B ? init_acc_word(acc_in, barb, gate, e - gi * CN, N, C, g.mu) : 0u;
  }
  __syncthreads();

  const int row_bytes = g.ncols * bs;  // one key row
  const size_t step_bytes = (size_t)g.D * Rbs * row_bytes;
  const int quads = row_bytes / 4;     // column quads per output block
  const uint32_t lmask = (1u << g.lb) - 1u, half = 1u << (g.lb - 1);

  for (int s = 0; s < g.n; ++s) {
    // 1-3: rotate by index, difference, decompose into int8 digit rows
    for (int e = tid; e < BT * CN; e += THREADS) {
      const int gi = e / CN, rem = e - gi * CN;
      const int c = rem / N, t = rem - c * N;
      const int gate = gate0 + gi;
      const int a = gate < B ? (bara[(size_t)gate * g.n + s] & (2 * N - 1)) : 0;
      const uint32_t x = cmux_diff(acc + gi * CN + c * N, t, a, N, g.offset);
      const int i = t / bs, q = t - i * bs;
      int8_t* d = dig + (size_t)gi * K + i * Rbs + c * bs + q;
      for (int lev = 0; lev < g.l; ++lev)
        d[lev * C * bs] = gadget_digit(x, 32 - (lev + 1) * g.lb, lmask, half);
    }
    __syncthreads();

    // 4-5: contract against the step's key slice, shift-add into acc
    const int8_t* fs = fb + (size_t)s * step_bytes;
    for (int item = tid; item < g.nb * quads; item += THREADS) {
      const int j = item / quads;
      const int col = (item - j * quads) * 4;
      int sum[BT][4];
#pragma unroll
      for (int gi = 0; gi < BT; ++gi)
#pragma unroll
        for (int c = 0; c < 4; ++c) sum[gi][c] = 0;
      for (int i = 0; i < g.nb; ++i) {
        const int m = (i - j + g.D) % g.D;
        const int8_t* krow = fs + (size_t)m * Rbs * row_bytes + col;
        const int8_t* drow = dig + i * Rbs;
        for (int kk = 0; kk < Rbs; kk += 16) {
          uint32_t v[4][4];  // v[u][c]: column c, rows kk+4u .. kk+4u+3
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            uint32_t w[4];
#pragma unroll
            for (int h = 0; h < 4; ++h)
              w[h] = __ldg(reinterpret_cast<const uint32_t*>(
                  krow + (size_t)(kk + 4 * u + h) * row_bytes));
            transpose4(w, v[u]);
          }
#pragma unroll
          for (int gi = 0; gi < BT; ++gi) {
            const int4 dw = *reinterpret_cast<const int4*>(drow + (size_t)gi * K + kk);
            const int dv[4] = {dw.x, dw.y, dw.z, dw.w};
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                sum[gi][c] = __dp4a((int)v[u][c], dv[u], sum[gi][c]);
          }
        }
      }
      const int ci = col / bs, q = col - ci * bs;  // bs % 4 == 0: one column
      const int shift = g.col_shift[ci];
      uint32_t* dst = acc + g.col_poly[ci] * N + j * bs + q;
#pragma unroll
      for (int gi = 0; gi < BT; ++gi)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          atomicAdd(dst + gi * CN + c, (uint32_t)sum[gi][c] << shift);
    }
    __syncthreads();
  }

  for (int e = tid; e < BT * CN; e += THREADS) {
    const int gi = e / CN;
    if (gate0 + gi < B) out[(size_t)(gate0 + gi) * CN + (e - gi * CN)] = (int32_t)acc[e];
  }
}

template <int BT>
static cudaError_t launch(int32_t* out, const int32_t* acc_in, const int32_t* barb,
                          const int32_t* bara, const int8_t* fb, int B,
                          const Geom& g, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      blind_rotate_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (B + BT - 1) / BT;
  blind_rotate_kernel<BT><<<blocks, THREADS, smem, stream>>>(out, acc_in, barb, bara, fb, B, g);
  return cudaGetLastError();
}

// acc_in == NULL selects the stepvec mode (barb and mu); otherwise barb is
// unused. bt is the tile of gates per block, one of 1, 2, 4, 8, 16; its
// shared memory is bt * (C*N*4 accumulator + l*C*N digit) bytes. Returns the
// CUDA error of the launch (0 on success).
extern "C" int blind_rotate_launch(void* out, const void* acc_in, const void* barb,
                                   const void* bara, const void* fb, int B, int bt,
                                   int n, int N, int bs, int C, int l, int lb,
                                   unsigned int offset, unsigned int mu, int ncols,
                                   const int* col_poly, const int* col_shift,
                                   void* stream) {
  if (ncols > MAX_COLS) return (int)cudaErrorInvalidValue;
  Geom g;
  g.n = n; g.N = N; g.bs = bs; g.nb = N / bs; g.D = 2 * N / bs; g.C = C;
  g.R = l * C; g.l = l; g.lb = lb; g.ncols = ncols; g.offset = offset; g.mu = mu;
  for (int i = 0; i < MAX_COLS; ++i) {
    g.col_poly[i] = i < ncols ? col_poly[i] : 0;
    g.col_shift[i] = i < ncols ? col_shift[i] : 0;
  }
  const size_t smem = (size_t)bt * C * N * 4 + (size_t)bt * l * C * N;
  auto o = static_cast<int32_t*>(out);
  auto ai = static_cast<const int32_t*>(acc_in);
  auto bb = static_cast<const int32_t*>(barb);
  auto ba = static_cast<const int32_t*>(bara);
  auto f = static_cast<const int8_t*>(fb);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (bt) {
    case 1: err = launch<1>(o, ai, bb, ba, f, B, g, smem, st); break;
    case 2: err = launch<2>(o, ai, bb, ba, f, B, g, smem, st); break;
    case 4: err = launch<4>(o, ai, bb, ba, f, B, g, smem, st); break;
    case 8: err = launch<8>(o, ai, bb, ba, f, B, g, smem, st); break;
    case 16: err = launch<16>(o, ai, bb, ba, f, B, g, smem, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
