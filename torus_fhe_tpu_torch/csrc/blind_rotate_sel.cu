// Blind rotate (the whole CMux chain) over the COMPACT F-block key, for NVIDIA
// Hopper (sm_90a): every CMux step is an int8 tensor-core GEMM spread over all
// SMs of the card, whose key operand is built on the SM from the key's lines.
//
// Replaces the Pallas TPU route torus_fhe_tpu/ops/fblock.py::
// blind_rotate_streamed(use_pallas=True): XLA expansion of each 64-step chunk
// of compact lines (expand_fblock_chunk), then the Pallas kernel
// (pallas_rotate.py:264) on the chunk. It is the 3gen multikey rotate at 4 and
// 8 parties (mk/boot3gen.py::_fast_rotate_extract) and the stage of the
// party-pipelined rotate over compact shards (parallel/mk_pipeline.py), in
// both init modes (explicit accumulator, or the stepvec gate test vector).
// Word-equal to the plain version torus_fhe_tpu_torch/ops/fblock.py::
// blind_rotate_streamed and to blind_rotate.cu over the expanded key.
//
// The key is the compact kernel layout (steps, ncols, R, 2N) int8
// (ops/fblock.to_sel_kernel_layout), a byte-exact permutation of
// fblock.build_sel's (steps, R, 2N, ncols): per step and limb column ci, the R
// extended lines ext_r = [k_r, -k_r] reversed, rev[g] = ext_r[(-g) mod 2N].
// (The second half of a line is read from the key, never made by negating
// bytes: the negation is in the torus domain, before the limb split.) Entry
// (digit u, coefficient t) of the expanded matrix of line r, column ci is
// rev[(u - t) mod 2N], so one step's whole key is R*2N*ncols bytes (128 KB at
// the 8-party 3gen set) against the expanded D*R*bs*ncols*bs (16.8 MB).
//
// What bounds it on this card: the int8 tensor-core rate. Per gate and step,
// ncols*N outputs each sum R*N products (67 M multiply-adds at 8 parties),
// against a key that is read from device memory once per chain (566 MB at 8
// parties: 0.17 ms), and digit rows that each column tile draws from L2
// (64 MB a step at 8 parties, B = 256: 9.3 us at 6.9 TB/s, under the 17.4 us
// of the MMAs). Measured on an NVIDIA H100 80GB HBM3 at 700.00 W, 8 parties,
// B = 256: an mma.sync tile of 64 x 64 (since removed) 257 ms (bound 75.0
// ms; the dp4a kernel this replaced took 1588 ms), held there by mma.sync's
// issue rate (about 3 clocks an MMA) and a block-wide barrier every 128-byte
// stage; 53 ms at B = 1. The wgmma tile (rotate_sel_wgmma.cuh) takes both
// away: 146 ms at B = 256. A stage of it reads about as many bytes of shared
// memory as the tensor cores can multiply in the same time, which is what
// bounds it next.
//
// What the design does (the body of the mma.sync tiles is rotate_gemm.cuh,
// shared with blind_rotate.cu; this file names the tiles):
//   * The frame is blind_rotate.cu's: one cooperative launch, a persistent
//     grid, per step a digit phase and a GEMM phase with a grid barrier after
//     each, accumulators and digit rows in global memory (L2), output tiles
//     (gates x one polynomial's limb columns of WQ coefficients) dealt
//     round-robin, an epilogue without atomics.
//   * The key operand of a stage (BK digits u0.. of line r, WQ coefficients
//     t0..) is a Toeplitz window: row t is the BK bytes rev[u0 - t ..], and
//     neighbouring rows are the same bytes shifted by one. The stage copies
//     the BK + WQ bytes rev[u0 - t0 - WQ ..] per limb (whole 16-byte chunks,
//     each wrapped mod 2N) instead of WQ * BK: 192 bytes against 8 KB at
//     WQ = 64. The key drops out of the L2-to-SM traffic.
//   * ldmatrix wants 16-byte aligned rows and row t starts at byte u0 - t, so
//     the fragments do not go through ldmatrix. The block makes three more
//     copies of a stage's windows in shared memory, copy s shifted by s bytes
//     (one funnel shift a word). An MMA's key fragment of a thread is words of
//     one coefficient's row: aligned words of copy (u0 - t) mod 4, read by
//     plain 4-byte loads. The copies lie 8 mod 16 words apart, so the 32
//     lanes of a load meet no bank conflict. (Tried beside it, all exact:
//     expanding the window into ldmatrix rows in shared memory, 1.7x slower;
//     four shifted copies of every line kept in global memory, as fast, at
//     four times the key.)
//   * The mma.sync tiles (mma.sync.m16n8k32 s8, a cp.async ring, the key as
//     the MMA's B operand) serve the batches of few tiles of few warps, so
//     the block splits the reduction: 16 x 16 with eight single warps for B
//     <= 16, 64 x 16 with four groups of four warps above, each group
//     through a ring of its own. 64 x 16 also takes every batch of a
//     geometry with fewer than four limb columns a polynomial (the
//     single-key sets' compact form, which no keygen of the port builds). A
//     stage must stay inside one line, so BK divides bs: N = 64 takes one 64
//     x 16 tile with 64-byte stages.
//   * Above one 64-gate tile, where every polynomial has four limb columns
//     (the 3gen sets), the GEMM phase is the tile of rotate_sel_wgmma.cuh:
//     the key window as the register operand of wgmma.m64n64k32, the digit
//     rows by a TMA ring, two warpgroups splitting the limbs. It beats the
//     mma.sync tiles there even at half the SMs (B = 96).
//   ops/cuda_rotate.sel_plan picks the tile from B and the geometry.
// The sums are exact: R*N products of |digit| <= 2^(lb-1) and |limb| <= 128,
// below 2^31 (checked by the wrapper; 2^23 at 8 parties, 2^25 at 2).

#include "rotate_sel_wgmma.cuh"  // and rotate_gemm.cuh

// One blind rotate of B gates over `steps` CMux steps: out (B, C, N) int32 is
// the accumulator in place. acc_in == NULL selects the stepvec mode (barb and
// mu); otherwise barb is unused. sel is the compact kernel layout (steps,
// ncols, R, 2N) int8; dig is B*R*N bytes of scratch. config picks the tile:
//   0: 16 gates x 16 coefficients, eight warps splitting the reduction;
//   1: 64 x 16, four groups of four warps splitting it;
//   2: 64 x 16 with 64-byte stages, for bs = 64;
//   3: the wgmma tile of rotate_sel_wgmma.cuh, 64 x 64, two consumer and one
//      producer warpgroup, every polynomial of four limb columns.
// All but 2 take 128-byte stages, which bs must be a multiple of. blocks is the
// grid asked for, which is cut to what is co-resident (at most the tile's
// RESIDENT blocks per SM) and reported in *grid_used. The limb columns of one
// polynomial must be consecutive, at most four. Returns the CUDA error of the
// launch (0 on success).
extern "C" int blind_rotate_sel_launch(void* out, const void* acc_in, const void* barb,
                                       const void* bara, const void* sel, void* dig, int B,
                                       int config, int blocks, int steps, int N, int bs, int C,
                                       int l, int lb, unsigned int offset, unsigned int mu,
                                       int ncols, const int* col_poly, const int* col_shift,
                                       void* stream, int* grid_used) {
  if (blocks < 1 || bs % 64) return (int)cudaErrorInvalidValue;
  if (config < 0 || config > 3 || (config != 2 && bs % 128)) return (int)cudaErrorInvalidValue;
  Geom g;
  if (!fill_geom(g, B, steps, N, bs, C, l, lb, offset, mu, ncols, col_poly, col_shift))
    return (int)cudaErrorInvalidValue;
  auto o = static_cast<uint32_t*>(out);
  auto ai = static_cast<const int32_t*>(acc_in);
  auto bb = static_cast<const int32_t*>(barb);
  auto ba = static_cast<const int32_t*>(bara);
  auto k = static_cast<const int8_t*>(sel);
  auto d = static_cast<int8_t*>(dig);
  auto st = static_cast<cudaStream_t>(stream);
  // Tile<COMPACT, WARPS_M, WARPS_N, WM, WNQ, STAGES, RESIDENT, BK[, KSPLIT]>
  using T0 = Tile<true, 1, 1, 1, 2, 4, 1, 128, 8>;
  using T1 = Tile<true, 4, 1, 1, 2, 4, 1, 128, 4>;
  using T2 = Tile<true, 4, 1, 1, 2, 4, 3, 64>;
  using T3 = sw::WgTile<true, 8, 4, 1>;  // WgTile<COMPACT, STAGES, NPROD, LAG>
  switch (config) {
    case 0: return (int)launch<T0>(o, ai, bb, ba, k, d, g, blocks, grid_used, st);
    case 1: return (int)launch<T1>(o, ai, bb, ba, k, d, g, blocks, grid_used, st);
    case 2: return (int)launch<T2>(o, ai, bb, ba, k, d, g, blocks, grid_used, st);
    case 3: return (int)sw::launch<T3>(o, ai, bb, ba, k, d, g, blocks, grid_used, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
