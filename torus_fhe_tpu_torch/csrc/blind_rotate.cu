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
//   * Step-synchronous, output-stationary over the whole card. One
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
//   * Four tile shapes (the wrapper's launch plan picks by B and the SM
//     count): 256 gates x 32 coefficients, 128 x 32, 64 x 16, and 16 x 8 for
//     B <= 16, with stages of 128 reduction bytes; a geometry whose R*bs is
//     no multiple of 128 takes one 64 x 16 tile with 64-byte stages.
// The grid never exceeds what is co-resident (occupancy query), so the
// barrier cannot deadlock, and two launches from two streams serialise.
// Measured on an H100 (700 W): at B = 1024 the tiles' traffic from L2 into the
// SMs (~3.5 TB/s) sets the pace, at a fifth of the tensor-core bound; a grid
// barrier costs 1.2 us.
//
// The sums are exact: each output sums K = R*N products of |digit| <= 2^(lb-1)
// and |limb| <= 128, so R*N*2^(lb-1)*128 < 2^31 bounds it (the wrapper checks
// this). Torus words are uint32_t; the int32 sums are shifted as uint32_t.
// The stepvec init and the digit are shared with blind_rotate_sel.cu
// (cmux_step.cuh).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cmux_step.cuh"

namespace cg = cooperative_groups;

#define MAX_COLS 32
#define MAX_LIMBS 4  // limb columns of one polynomial (32-bit torus)

struct Geom {
  int B, n, N, bs, nb, D, C, R, l, lb, ncols;
  uint32_t offset, mu;
  int poly_col[MAX_COLS];   // first limb column of polynomial c
  int poly_nl[MAX_COLS];    // its number of limb columns, 1..MAX_LIMBS
  int col_shift[MAX_COLS];  // shift of limb column ci
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; bytes == 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Four 8x8 matrices of 16-bit pairs: lanes 8k..8k+7 give the row addresses of
// matrix k; lane t receives bytes 4*(t%4)..+3 of row t/4 of each matrix, which
// is the int8 fragment layout of mma.m16n8k32 (four reduction bytes a register).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of BK-byte rows
// (BK = 64 or 128). The chunk index is XORed with row bits (bits 1-2 for
// 64-byte rows, bits 0-2 for longer ones), so that the eight consecutive rows
// of one chunk that an ldmatrix phase reads fall into eight distinct 16-byte
// bank groups.
template <int BK>
__device__ __forceinline__ uint32_t tile_offset(int row, int chunk) {
  const int x = BK == 64 ? (row >> 1) & 3 : row & 7;
  return (uint32_t)(row * BK + ((chunk ^ x) << 4));
}

// (X^a * p)[t] for one accumulator polynomial p of N words in global memory,
// a in [0, 2N): read by index, negated past the wrap (cmux_step.cuh's
// cmux_diff, with loads that bypass L1: other SMs wrote these words).
__device__ __forceinline__ uint32_t rotated_word(const uint32_t* p, int t, int a, int N) {
  const int a1 = a & (N - 1);
  uint32_t r = t >= a1 ? __ldcg(p + t - a1) : 0u - __ldcg(p + t - a1 + N);
  return a >= N ? 0u - r : r;
}

// Block tile: BM = WARPS_M*WM*16 gates x (one polynomial's limb columns of
// WQ = WARPS_N*WNQ*8 coefficients). A warp holds WM m16 row tiles x WNQ groups
// of 8 coefficients x up to 4 limbs. A pipeline stage holds BK reduction
// bytes (a multiple of 64: two k32 MMA steps) of every row. RESIDENT blocks
// share an SM at most. With KSPLIT > 1 the block is KSPLIT such groups of
// warps (of one warp each): group w takes the stages kc = w mod KSPLIT through
// a ring of its own, with no block-wide barrier on the way, and the groups'
// sums are added through shared memory at the end. That is for the smallest
// tile, where one gate's chain waits on a lone warp's loads.
template <int WARPS_M_, int WARPS_N_, int WM_, int WNQ_, int STAGES_, int RESIDENT_, int BK_,
          int KSPLIT_ = 1>
struct Tile {
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_, WM = WM_, WNQ = WNQ_;
  static constexpr int STAGES = STAGES_, RESIDENT = RESIDENT_, KSPLIT = KSPLIT_;
  static constexpr int GROUP = WARPS_M * WARPS_N * 32;  // threads that share a ring
  static_assert(KSPLIT_ == 1 || GROUP == 32, "a split group is one warp: it syncs by itself");
  static constexpr int BK = BK_, CH = BK_ / 16;  // 16-byte chunks of a row
  static_assert(BK_ == 64 || BK_ == 128, "tile_offset covers these");
  static constexpr int THREADS = GROUP * KSPLIT;
  static constexpr int BM = WARPS_M * WM * 16;
  static constexpr int WQ = WARPS_N * WNQ * 8;
  static constexpr int BROWS = MAX_LIMBS * WQ;  // key rows of a stage
  static constexpr int STAGE_BYTES = (BM + BROWS) * BK;
  static constexpr int SMEM = KSPLIT * STAGES * STAGE_BYTES;
  static constexpr int A_PER = BM * CH / GROUP;  // 16-byte chunks a thread loads
  static constexpr int B_PER = BROWS * CH / GROUP;
  static_assert(A_PER * GROUP == BM * CH, "digit chunks must split evenly");
  static_assert(B_PER * GROUP == BROWS * CH, "key chunks must split evenly");
  static_assert((KSPLIT - 1) * WM * WNQ * MAX_LIMBS * 4 * GROUP * 4 <= SMEM,
                "the groups' sums pass through the ring");
};

template <class T>
__device__ __forceinline__ void gemm_tile(uint32_t* acc, const int8_t* __restrict__ key_step,
                                          const int8_t* dig, const Geom& g,
                                          int mt, int j, int poly, int qt,
                                          unsigned char* smem) {
  constexpr int WARPS_M = T::WARPS_M, WM = T::WM, WNQ = T::WNQ, STAGES = T::STAGES;
  constexpr int BK = T::BK, CH = T::CH, KS = T::KSPLIT;
  // grp: which stages of the reduction this thread's group takes; tid: within the group
  const int grp = KS == 1 ? 0 : threadIdx.x / T::GROUP;
  const int tid = KS == 1 ? threadIdx.x : threadIdx.x % T::GROUP, lane = tid & 31, warp = tid >> 5;
  const int B = g.B, N = g.N, bs = g.bs;
  const int Rbs = g.R * bs;
  const int K = g.nb * Rbs;
  const int nk_i = Rbs / BK;        // stages per digit block
  const int nk = g.nb * nk_i;
  const size_t mblock = (size_t)g.ncols * bs * Rbs;  // bytes of one key block m
  const int m0 = mt * T::BM, q0 = qt * T::WQ;
  const int nl = g.poly_nl[poly], col0 = g.poly_col[poly];
  const uint32_t sbase = smem_u32(smem) + (uint32_t)(grp * STAGES * T::STAGE_BYTES);

  // what this thread copies per stage: digit rows (zeros past gate B), and the
  // key rows of limb `row / WQ`, coefficient q0 + row % WQ
  const int8_t* a_src[T::A_PER];
  uint32_t a_dst[T::A_PER];
  int a_bytes[T::A_PER];
#pragma unroll
  for (int u = 0; u < T::A_PER; ++u) {
    const int cid = tid + u * T::GROUP, row = cid / CH, ch = cid % CH;
    const int gate = m0 + row;
    a_bytes[u] = gate < B ? 16 : 0;
    a_src[u] = dig + (size_t)(gate < B ? gate : B - 1) * K + ch * 16;
    a_dst[u] = tile_offset<BK>(row, ch);
  }
  const int8_t* b_src[T::B_PER];
  uint32_t b_dst[T::B_PER];
  bool b_ok[T::B_PER];
#pragma unroll
  for (int u = 0; u < T::B_PER; ++u) {
    const int cid = tid + u * T::GROUP, row = cid / CH, ch = cid % CH;
    const int limb = row / T::WQ, q = row - limb * T::WQ;
    b_ok[u] = limb < nl;
    b_src[u] = key_step + ((size_t)(col0 + (b_ok[u] ? limb : 0)) * bs + q0 + q) * Rbs + ch * 16;
    b_dst[u] = (uint32_t)(T::BM * BK) + tile_offset<BK>(row, ch);
  }

  // the group's c-th stage is stage kc = grp + c * KS of the reduction
  const int nkg = (nk - grp + KS - 1) / KS;
  auto load = [&](int c) {
    const int kc = grp + c * KS;
    const int i = kc / nk_i, kk = (kc - i * nk_i) * BK;
    const int m = i >= j ? i - j : i - j + g.D;
    const size_t boff = (size_t)m * mblock + kk;
    const uint32_t st = sbase + (uint32_t)((c % STAGES) * T::STAGE_BYTES);
#pragma unroll
    for (int u = 0; u < T::A_PER; ++u)
      cp_async16(st + a_dst[u], a_src[u] + (size_t)kc * BK, a_bytes[u]);
#pragma unroll
    for (int u = 0; u < T::B_PER; ++u)
      if (b_ok[u]) cp_async16(st + b_dst[u], b_src[u] + boff, 16);
  };

  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int wrow0 = wm * WM * 16, wq0 = wn * WNQ * 8;
  const int lrow = lane & 7, lmat = lane >> 3;

  int sum[WM][WNQ][MAX_LIMBS][4];
#pragma unroll
  for (int mi = 0; mi < WM; ++mi)
#pragma unroll
    for (int qg = 0; qg < WNQ; ++qg)
#pragma unroll
      for (int lim = 0; lim < MAX_LIMBS; ++lim)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[mi][qg][lim][e] = 0;

#pragma unroll
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nkg) load(c);
    cp_async_commit();
  }
  for (int c = 0; c < nkg; ++c) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of stage c have landed
    // everyone's of the group have, and stage c-1 is consumed
    if constexpr (KS == 1) __syncthreads(); else __syncwarp();
    if (c + STAGES - 1 < nkg) load(c + STAGES - 1);
    cp_async_commit();
    const uint32_t sA = sbase + (uint32_t)((c % STAGES) * T::STAGE_BYTES);
    const uint32_t sB = sA + (uint32_t)(T::BM * BK);
    uint32_t bk64[WNQ % 2 ? WNQ : 1][MAX_LIMBS][4];  // odd WNQ only, see below
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      // digit fragments: matrices (rows 0-7, k 0-15), (rows 8-15, k 0-15),
      // (rows 0-7, k 16-31), (rows 8-15, k 16-31) of the m16 x k32 tile
      uint32_t af[WM][4];
#pragma unroll
      for (int mi = 0; mi < WM; ++mi)
        ldmatrix_x4(af[mi], sA + tile_offset<BK>(wrow0 + mi * 16 + lrow + (lmat & 1) * 8,
                                                 ks * 2 + (lmat >> 1)));
      if constexpr (WNQ % 2 == 0) {
        // key fragments of two coefficient groups: matrices (group 2p, k 0-15),
        // (2p, k 16-31), (2p + 1, k 0-15), (2p + 1, k 16-31)
#pragma unroll
        for (int p = 0; p < WNQ / 2; ++p)
#pragma unroll
          for (int lim = 0; lim < MAX_LIMBS; ++lim)
            if (lim < nl) {
              uint32_t bf[4];
              ldmatrix_x4(bf, sB + tile_offset<BK>(lim * T::WQ + wq0 + (2 * p + (lmat >> 1)) * 8 +
                                                       lrow, ks * 2 + (lmat & 1)));
#pragma unroll
              for (int mi = 0; mi < WM; ++mi) {
                mma_s8(sum[mi][2 * p][lim], af[mi], bf[0], bf[1]);
                mma_s8(sum[mi][2 * p + 1][lim], af[mi], bf[2], bf[3]);
              }
            }
      } else {
        // one group of coefficients per limb: the fragments of this and the
        // next k32 step at once, matrix `lmat` being reduction bytes
        // 16*lmat..+15 of a 64-byte piece (a lone warp has no other warp to
        // hide the load behind, so it asks early)
        if (ks % 2 == 0) {
#pragma unroll
          for (int qg = 0; qg < WNQ; ++qg)
#pragma unroll
            for (int lim = 0; lim < MAX_LIMBS; ++lim)
              if (lim < nl)
                ldmatrix_x4(bk64[qg][lim], sB + tile_offset<BK>(lim * T::WQ + wq0 + qg * 8 + lrow,
                                                               ks * 2 + lmat));
        }
#pragma unroll
        for (int mi = 0; mi < WM; ++mi)
#pragma unroll
          for (int qg = 0; qg < WNQ; ++qg)
#pragma unroll
            for (int lim = 0; lim < MAX_LIMBS; ++lim)
              if (lim < nl)
                mma_s8(sum[mi][qg][lim], af[mi], bk64[qg][lim][2 * (ks % 2)],
                       bk64[qg][lim][2 * (ks % 2) + 1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the block's next tile

  if constexpr (KS > 1) {
    // groups 1.. hand their sums to group 0 through the (free) ring
    int* red = reinterpret_cast<int*>(smem);
    constexpr int PER = WM * WNQ * MAX_LIMBS * 4;
    if (grp > 0) {
#pragma unroll
      for (int mi = 0; mi < WM; ++mi)
#pragma unroll
        for (int qg = 0; qg < WNQ; ++qg)
#pragma unroll
          for (int lim = 0; lim < MAX_LIMBS; ++lim)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              red[((grp - 1) * PER + ((mi * WNQ + qg) * MAX_LIMBS + lim) * 4 + e) * T::GROUP +
                  tid] = sum[mi][qg][lim][e];
    }
    __syncthreads();
    if (grp == 0) {
      for (int w = 0; w < KS - 1; ++w)
#pragma unroll
        for (int mi = 0; mi < WM; ++mi)
#pragma unroll
          for (int qg = 0; qg < WNQ; ++qg)
#pragma unroll
            for (int lim = 0; lim < MAX_LIMBS; ++lim)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                sum[mi][qg][lim][e] +=
                    red[(w * PER + ((mi * WNQ + qg) * MAX_LIMBS + lim) * 4 + e) * T::GROUP + tid];
    }
    __syncthreads();  // read before the next tile's loads land in the ring
    if (grp > 0) return;
  }

  // epilogue: this thread holds, for rows lane/4 and lane/4 + 8 of each m16
  // tile and coefficients 2*(lane%4), +1 of each group, every limb's sum
  uint32_t shift[MAX_LIMBS];
#pragma unroll
  for (int lim = 0; lim < MAX_LIMBS; ++lim) shift[lim] = lim < nl ? g.col_shift[col0 + lim] : 0;
#pragma unroll
  for (int mi = 0; mi < WM; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gate = m0 + wrow0 + mi * 16 + (lane >> 2) + 8 * h;
      if (gate >= B) continue;
#pragma unroll
      for (int qg = 0; qg < WNQ; ++qg) {
        uint32_t v0 = 0, v1 = 0;
#pragma unroll
        for (int lim = 0; lim < MAX_LIMBS; ++lim)
          if (lim < nl) {
            v0 += (uint32_t)sum[mi][qg][lim][2 * h] << shift[lim];
            v1 += (uint32_t)sum[mi][qg][lim][2 * h + 1] << shift[lim];
          }
        uint2* dst = reinterpret_cast<uint2*>(acc + ((size_t)gate * g.C + poly) * N + j * bs +
                                              q0 + wq0 + qg * 8 + 2 * (lane & 3));
        uint2 w = __ldcg(dst);
        w.x += v0;
        w.y += v1;
        *dst = w;
      }
    }
}

template <class T>
__global__ void __launch_bounds__(T::THREADS, T::RESIDENT)
    blind_rotate_kernel(uint32_t* acc, const int32_t* __restrict__ acc_in,
                        const int32_t* __restrict__ barb, const int32_t* __restrict__ bara,
                        const int8_t* __restrict__ key, int8_t* dig, Geom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int B = g.B, N = g.N, C = g.C, bs = g.bs;
  const int CN = C * N;
  const int Rbs = g.R * bs;
  const int K = g.nb * Rbs;
  const int gtid = blockIdx.x * T::THREADS + threadIdx.x;
  const int gthreads = gridDim.x * T::THREADS;

  // phase 0: the initial accumulator, in the output tensor (B * CN < 2^31,
  // so the unsigned index cannot wrap past it)
  for (unsigned e = gtid; e < (unsigned)(B * CN); e += gthreads) {
    const int gate = (int)(e / (unsigned)CN);
    acc[e] = init_acc_word(acc_in, barb, gate, (int)e - gate * CN, N, C, g.mu);
  }
  grid.sync();

  const size_t step_bytes = (size_t)g.D * g.ncols * bs * Rbs;
  const uint32_t lmask = (1u << g.lb) - 1u, half = 1u << (g.lb - 1);
  const int quads = CN / 4, nquad = N / 4;
  const int MT = (B + T::BM - 1) / T::BM, QT = bs / T::WQ;
  const int tiles = MT * g.nb * C * QT;

  for (int s = 0; s < g.n; ++s) {
    // phase 1: four coefficients a thread: rotate by index, difference, and
    // the l digits of each, packed four to a word of the digit rows. (Giving a
    // thread two or four such items at once, all loads first, made the whole
    // kernel 5% slower on an H100.)
    for (int e = gtid; e < B * quads; e += gthreads) {
      const int gate = e / quads, rem = e - gate * quads;
      const int c = rem / nquad, t4 = (rem - c * nquad) * 4;
      const int a = __ldg(bara + (size_t)gate * g.n + s) & (2 * N - 1);
      const uint32_t* p = acc + ((size_t)gate * C + c) * N;
      const uint4 own = __ldcg(reinterpret_cast<const uint4*>(p + t4));
      uint32_t x[4];
      x[0] = rotated_word(p, t4, a, N) - own.x + g.offset;
      x[1] = rotated_word(p, t4 + 1, a, N) - own.y + g.offset;
      x[2] = rotated_word(p, t4 + 2, a, N) - own.z + g.offset;
      x[3] = rotated_word(p, t4 + 3, a, N) - own.w + g.offset;
      const int i = t4 / bs, q = t4 - i * bs;
      int8_t* d = dig + (size_t)gate * K + i * Rbs + c * bs + q;
      for (int lev = 0; lev < g.l; ++lev) {
        const int sh = 32 - (lev + 1) * g.lb;
        uint32_t packed = 0;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          packed |= (uint32_t)(uint8_t)gadget_digit(x[u], sh, lmask, half) << (8 * u);
        *reinterpret_cast<uint32_t*>(d + (size_t)lev * C * bs) = packed;
      }
    }
    grid.sync();

    // phase 2: the step's GEMM; gate tiles of one key box run side by side
    const int8_t* key_step = key + (size_t)s * step_bytes;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int mt = tile % MT;
      int nt = tile / MT;
      const int qt = nt % QT;
      nt /= QT;
      const int poly = nt % C, j = nt / C;
      gemm_tile<T>(acc, key_step, dig, g, mt, j, poly, qt, smem);
    }
    grid.sync();
  }
}

template <class T>
static cudaError_t launch(uint32_t* acc, const int32_t* acc_in, const int32_t* barb,
                          const int32_t* bara, const int8_t* key, int8_t* dig, Geom g,
                          int blocks, int* grid_used, cudaStream_t stream) {
  auto kernel = blind_rotate_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::SMEM);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T::THREADS, T::SMEM);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  if (per_sm > T::RESIDENT) per_sm = T::RESIDENT;
  // the grid barrier needs every block resident at once
  const int grid = blocks < per_sm * sms ? blocks : per_sm * sms;
  if (grid_used != nullptr) *grid_used = grid;
  void* args[] = {&acc, &acc_in, &barb, &bara, &key, &dig, &g};
  return cudaLaunchCooperativeKernel((void*)kernel, dim3(grid), dim3(T::THREADS), args,
                                     T::SMEM, stream);
}

// One blind rotate of B gates: out (B, C, N) int32 is the accumulator in
// place. acc_in == NULL selects the stepvec mode (barb and mu); otherwise barb
// is unused. key is the kernel layout (n, D, ncols*bs, R*bs) int8; dig is
// B*R*N bytes of scratch. config picks the tile (0: 16 gates x 8
// coefficients; 1: 64 x 16; 2: 128 x 32; 3: 256 x 32, all with 128-byte
// pipeline stages, which R*bs must be a multiple of; 4: 64 x 16 with 64-byte
// stages, which take every geometry), blocks the grid asked for, which is cut to what is co-resident (at most the tile's RESIDENT blocks
// per SM) and reported in *grid_used. The limb columns of one polynomial must
// be consecutive, at most four. Returns the CUDA error of the launch (0 on
// success).
extern "C" int blind_rotate_launch(void* out, const void* acc_in, const void* barb,
                                   const void* bara, const void* key, void* dig, int B,
                                   int config, int blocks, int n, int N, int bs, int C, int l,
                                   int lb, unsigned int offset, unsigned int mu, int ncols,
                                   const int* col_poly, const int* col_shift, void* stream,
                                   int* grid_used) {
  if (ncols < 1 || ncols > MAX_COLS || C < 1 || C > MAX_COLS || B < 1 || blocks < 1 ||
      N % bs || bs % 32 || (l * C * bs) % 64)
    return (int)cudaErrorInvalidValue;
  if (config < 0 || config > 4 || (config < 4 && (l * C * bs) % 128))
    return (int)cudaErrorInvalidValue;
  Geom g;
  g.B = B; g.n = n; g.N = N; g.bs = bs; g.nb = N / bs; g.D = 2 * N / bs; g.C = C;
  g.R = l * C; g.l = l; g.lb = lb; g.ncols = ncols; g.offset = offset; g.mu = mu;
  for (int i = 0; i < MAX_COLS; ++i) {
    g.poly_col[i] = 0; g.poly_nl[i] = 0;
    g.col_shift[i] = i < ncols ? col_shift[i] : 0;
  }
  for (int ci = 0; ci < ncols; ++ci) {
    const int p = col_poly[ci];
    if (p < 0 || p >= C) return (int)cudaErrorInvalidValue;
    if (g.poly_nl[p] == 0) g.poly_col[p] = ci;
    if (g.poly_col[p] + g.poly_nl[p] != ci || g.poly_nl[p] == MAX_LIMBS)
      return (int)cudaErrorInvalidValue;  // not consecutive, or more than four
    ++g.poly_nl[p];
  }
  for (int p = 0; p < C; ++p)
    if (g.poly_nl[p] == 0) return (int)cudaErrorInvalidValue;
  auto o = static_cast<uint32_t*>(out);
  auto ai = static_cast<const int32_t*>(acc_in);
  auto bb = static_cast<const int32_t*>(barb);
  auto ba = static_cast<const int32_t*>(bara);
  auto k = static_cast<const int8_t*>(key);
  auto d = static_cast<int8_t*>(dig);
  auto st = static_cast<cudaStream_t>(stream);
  switch (config) {
    // Tile<WARPS_M, WARPS_N, WM, WNQ, STAGES, RESIDENT, BK[, KSPLIT]>
    case 0:
      return (int)launch<Tile<1, 1, 1, 1, 3, 3, 128, 4>>(o, ai, bb, ba, k, d, g, blocks, grid_used,
                                                         st);
    case 1:
      return (int)launch<Tile<4, 1, 1, 2, 3, 3, 128>>(o, ai, bb, ba, k, d, g, blocks, grid_used, st);
    case 2:
      return (int)launch<Tile<4, 2, 2, 2, 4, 1, 128>>(o, ai, bb, ba, k, d, g, blocks, grid_used, st);
    case 3:
      return (int)launch<Tile<4, 2, 4, 2, 3, 1, 128>>(o, ai, bb, ba, k, d, g, blocks, grid_used, st);
    case 4:
      return (int)launch<Tile<4, 1, 1, 2, 4, 3, 64>>(o, ai, bb, ba, k, d, g, blocks, grid_used, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
