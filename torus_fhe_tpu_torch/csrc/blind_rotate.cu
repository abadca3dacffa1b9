// Blind rotate (the whole n-step CMux chain) over the expanded F-block key,
// for NVIDIA Hopper (sm_90a): every CMux step is an int8 tensor-core GEMM
// spread over all SMs of the card.
//
// Replaces the Pallas TPU kernel torus_fhe_tpu/ops/pallas_rotate.py
// (_rotate_kernel via blind_rotate_pallas), in both of its init modes: an
// explicit (B, C, N) accumulator, or the gate test vector built in-kernel
// from barb ("stepvec"). The result is word-equal to it and to the plain
// PyTorch version, torus_fhe_tpu_torch/ops/fblock.py::blind_rotate_fblock:
// everything is exact integer arithmetic mod 2^32.
//
// What bounds it on this card. A step is the GEMM digits (B x K, K = R*N)
// times the step's key (K x nb*ncols*bs), int8 in, int32 out: 2*B*K*nb*ncols*bs
// operations against the key's D*R*bs*ncols*bs bytes, which are read once per
// chain. At tfhe_128_tpu_fast that is 34.6 MOP per gate and step against
// 8.65 MB of key, so above about 64 gates the int8 tensor-core rate bounds the
// chain and below that the device-memory rate of the key stream does.
//
// What the design does about it:
//   * Up to 3 gates (config 5): the latency tile of rotate_latency.cuh.
//     Key-stationary: each block owns a fixed box of the step's key (block
//     m, one polynomial, 32 coefficients) and multiplies it by every digit
//     block it pairs with (warpgroup MMAs), so a key byte lands in one SM
//     once a step; a producer warp streams the boxes by TMA up to four steps
//     ahead of the chain; the blocks build their own digit rows; the partial
//     sums are added with red.global.add into ping-pong accumulators, one
//     grid barrier a step. The key's device-memory floor is 2.37 ms a rotate
//     at tfhe_128; the chain bounds it above that: the digit rows' L2 reads,
//     the MMAs, the adds and the barrier, ~6 us a step at one gate.
//   * Above: step-synchronous, output-stationary over the whole card. One
//     cooperative launch runs a persistent grid; each step's output tiles
//     (M tile of gates x one polynomial's limb columns of WQ coefficients of
//     output block j) are dealt round-robin to the blocks. A key byte then
//     serves a whole M tile per trip from L2, and a single gate's columns
//     spread over every SM, so the key streams at the card's rate.
//   * The accumulators (the output tensor itself) and the int8 digit rows
//     live in global memory, resident in L2. A step is two phases with a
//     grid-wide barrier (cooperative_groups grid sync) after each:
//       1. rotate by index, difference, gadget digits, written as int8 rows
//          with the reduction index k = i*R*bs + (lev*C + c)*bs + p contiguous;
//       2. the GEMM. The tile's threads hold all limb columns of their
//          coefficients, so the epilogue combines sum << shift over the limbs
//          in registers and adds into the accumulator without atomics.
//   * Tensor cores: mma.sync.m16n8k32 s8 x s8 -> s32, fragments by ldmatrix
//     from shared memory with the reduction index contiguous on both sides.
//     The key comes in the kernel layout (n, D, ncols*bs, R*bs)
//     (ops/fblock.to_kernel_layout): output block j, digit block i reads
//     block m = (i - j) mod D, so a B tile is a plain box of that array.
//   * Both operands arrive through a ring of cp.async (16-byte) stages, BK
//     bytes of the reduction per stage, chunk c + STAGES - 1 in flight while
//     chunk c multiplies; shared-memory rows are XOR-swizzled so that the
//     eight rows of an ldmatrix phase meet no bank conflict.
//   * Three mma.sync tile shapes (the wrapper's launch plan picks by B and
//     the SM count): 128 gates x 32 coefficients, 64 x 16, and 16 x 8 for
//     B <= 16 (above the latency tile's 4), with stages of 128 reduction
//     bytes; a geometry whose R*bs is no multiple of 128 takes one 64 x 16
//     tile with 64-byte stages.
//   * At wide batches (128-gate tiles of 64 coefficients that fill every SM)
//     the GEMM phase is the tile of rotate_wgmma.cuh instead: warpgroup MMAs
//     from a TMA ring, the key box multicast to a 2-block cluster.
// The grid never exceeds what is co-resident (occupancy query), so the
// barrier cannot deadlock, and two launches from two streams serialise.
// Measured on an H100 (700 W): the mma.sync tiles at B = 1024 drew ~3.0 TB/s
// from L2 into the SMs at a quarter of the tensor-core bound (127 ms a rotate
// at tfhe_128); the wgmma tile takes 75 ms, its TMA loads alone 64 ms of it.
// A grid barrier costs 1.2 us.
//
// The sums are exact: each output sums K = R*N products of |digit| <= 2^(lb-1)
// and |limb| <= 128, so R*N*2^(lb-1)*128 < 2^31 bounds it (the wrapper checks
// this). Torus words are uint32_t; the int32 sums are shifted as uint32_t.
// The kernel's body is rotate_gemm.cuh, shared with blind_rotate_sel.cu, which
// differs in where a tile's key operand comes from; the tiles are named here.

#include "rotate_latency.cuh"  // and rotate_wgmma.cuh, rotate_gemm.cuh

// One blind rotate of B gates: out (B, C, N) int32 is the accumulator in
// place. acc_in == NULL selects the stepvec mode (barb and mu); otherwise barb
// is unused. key is the kernel layout (n, D, ncols*bs, R*bs) int8; dig is
// the scratch: B*R*N bytes of digit rows, or for config 5 the second
// accumulator (B*C*N words) and a barrier word. config picks the tile (0:
// 16 gates x 8 coefficients; 1: 64 x 16; 2: 128 x 32, all with 128-byte
// pipeline stages, which R*bs must be a multiple of; 3: 64 x 16 with
// 64-byte stages, which take every geometry; 4: the wgmma tile, 128 x 64
// in clusters of two, 128-byte stages, bs a multiple of 64; 5: the latency
// tile, key-stationary, at most 3 gates, its grid the key boxes of a step,
// one an SM, which `blocks` must equal; `layout` is its plan, {units, slots,
// shared-memory bytes, pace_ns}, and NULL for the others), blocks the grid
// asked for, which is cut to what is co-resident (at most the tile's
// RESIDENT blocks per SM) and reported in *grid_used. The limb columns of
// one polynomial must be consecutive, at most four. Returns the CUDA error
// of the launch (0 on success).
extern "C" int blind_rotate_launch(void* out, const void* acc_in, const void* barb,
                                   const void* bara, const void* key, void* dig, int B,
                                   int config, int blocks, int n, int N, int bs, int C, int l,
                                   int lb, unsigned int offset, unsigned int mu, int ncols,
                                   const int* col_poly, const int* col_shift, const int* layout,
                                   void* stream, int* grid_used) {
  if (blocks < 1 || bs % 32 || (l * C * bs) % 64) return (int)cudaErrorInvalidValue;
  if (config < 0 || config > 5 || (config != 3 && (l * C * bs) % 128))
    return (int)cudaErrorInvalidValue;
  Geom g;
  if (!fill_geom(g, B, n, N, bs, C, l, lb, offset, mu, ncols, col_poly, col_shift))
    return (int)cudaErrorInvalidValue;
  auto o = static_cast<uint32_t*>(out);
  auto ai = static_cast<const int32_t*>(acc_in);
  auto bb = static_cast<const int32_t*>(barb);
  auto ba = static_cast<const int32_t*>(bara);
  auto k = static_cast<const int8_t*>(key);
  auto d = static_cast<int8_t*>(dig);
  auto st = static_cast<cudaStream_t>(stream);
  // Tile<COMPACT, WARPS_M, WARPS_N, WM, WNQ, STAGES, RESIDENT, BK[, KSPLIT]>
  using T0 = Tile<false, 1, 1, 1, 1, 3, 3, 128, 4>;
  using T1 = Tile<false, 4, 1, 1, 2, 3, 3, 128>;
  using T2 = Tile<false, 4, 2, 2, 2, 4, 1, 128>;
  using T3 = Tile<false, 4, 1, 1, 2, 4, 3, 64>;
  switch (config) {
    case 0: return (int)launch<T0>(o, ai, bb, ba, k, d, g, blocks, grid_used, st);
    case 1: return (int)launch<T1>(o, ai, bb, ba, k, d, g, blocks, grid_used, st);
    case 2: return (int)launch<T2>(o, ai, bb, ba, k, d, g, blocks, grid_used, st);
    case 3: return (int)launch<T3>(o, ai, bb, ba, k, d, g, blocks, grid_used, st);
    case 4: return (int)wg::launch(o, ai, bb, ba, k, d, g, blocks, grid_used, st);
    case 5: return (int)lat::launch(o, ai, bb, ba, k, d, g, blocks, layout, grid_used, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
