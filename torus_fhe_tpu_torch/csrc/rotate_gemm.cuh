// The blind rotate as a chain of int8 tensor-core GEMMs, one cooperative
// launch a rotate: what blind_rotate.cu (over the expanded F-block key) and
// blind_rotate_sel.cu (over the compact key lines) share. The two differ in
// the producer of a GEMM tile's key operand, which is the template parameter
// Tile::COMPACT:
//   * expanded: a stage's key rows are plain boxes of the kernel layout
//     (n, D, ncols*bs, R*bs), copied by cp.async and read by ldmatrix;
//   * compact: the same rows are a Toeplitz window of one reversed key line,
//     BK + WQ bytes a limb instead of WQ * BK. cp.async brings the window, the
//     block makes three byte-shifted copies of it in shared memory, and every
//     thread reads its MMA fragments as aligned words from the copy that its
//     coefficient's shift selects. No expanded key exists anywhere.
// Everything else is common: per step a digit phase and a GEMM phase with a
// grid-wide barrier after each, accumulators and int8 digit rows in global
// memory (L2), mma.sync.m16n8k32 s8, digit fragments by ldmatrix from
// XOR-swizzled rows, a ring of cp.async stages, and an epilogue in which a
// thread holds every limb of its coefficients and adds without atomics.
// Torus words are uint32_t; the int32 sums are shifted as uint32_t.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Word rem = c*N + w of one gate's initial accumulator: the explicit acc_in,
// or (acc_in == NULL, "stepvec") the gate test vector
// X^-barb * (0, .., 0, [mu..mu]), whose body is a +-mu step function of w.
__device__ __forceinline__ uint32_t init_acc_word(const int32_t* acc_in,
                                                  const int32_t* barb, int gate,
                                                  int rem, int N, int C, uint32_t mu) {
  if (acc_in != nullptr) return (uint32_t)acc_in[(size_t)gate * C * N + rem];
  const int c = rem / N, w = rem - c * N;
  if (c != C - 1) return 0u;
  const int t = barb[gate] & (2 * N - 1);
  const bool pos = (w < N - (t & (N - 1))) != (t >= N);
  return pos ? mu : 0u - mu;
}

// Gadget digit of x at shift = 32 - (lev+1)*lb: ((x >> shift) & (Bg-1)) -
// Bg/2, in [-Bg/2, Bg/2) (lb <= 8, so it fits an int8). mask = Bg-1 and
// half = Bg/2 are computed once per kernel by the caller, not per digit.
__device__ __forceinline__ int8_t gadget_digit(uint32_t x, int shift, uint32_t mask,
                                               uint32_t half) {
  return (int8_t)(((x >> shift) & mask) - half);
}

// (X^a * p)[t] for one accumulator polynomial p of N words in global memory,
// a in [0, 2N): read by index, negated past the wrap, with loads that bypass
// L1: other SMs wrote these words.
__device__ __forceinline__ uint32_t rotated_word(const uint32_t* p, int t, int a, int N) {
  const int a1 = a & (N - 1);
  uint32_t r = t >= a1 ? __ldcg(p + t - a1) : 0u - __ldcg(p + t - a1 + N);
  return a >= N ? 0u - r : r;
}

// Words between two byte-shifted copies of a compact window of `bytes` bytes:
// room for the window, and 8 mod 16, so that the four copies start eight
// banks apart and the 32 lanes of a fragment load (at most six neighbouring
// words of each copy) meet no bank conflict.
constexpr int window_stride(int bytes) {
  int w = bytes / 4;
  while (w % 16 != 8) ++w;
  return w;
}

// Block tile: BM = WARPS_M*WM*16 gates x (one polynomial's limb columns of
// WQ = WARPS_N*WNQ*8 coefficients). A warp holds WM m16 row tiles x WNQ groups
// of 8 coefficients x up to 4 limbs. A pipeline stage holds BK reduction
// bytes (a multiple of 64: two k32 MMA steps) of every row. RESIDENT blocks
// share an SM at most. With KSPLIT > 1 the block is KSPLIT such groups of
// warps: group w takes the stages kc = w mod KSPLIT through a ring of its own,
// with no block-wide barrier on the way, and the groups' sums are added
// through shared memory at the end. That is for the small tiles, where few
// gates' chains would wait on a few warps' loads.
// The key side of a stage: expanded, MAX_LIMBS*WQ rows of BK bytes; COMPACT,
// per limb four copies of the window of WLEN = BK + WQ bytes of the reversed
// line, copy j shifted by j bytes, W words apart.
template <bool COMPACT_, int WARPS_M_, int WARPS_N_, int WM_, int WNQ_, int STAGES_,
          int RESIDENT_, int BK_, int KSPLIT_ = 1>
struct Tile {
  static constexpr bool COMPACT = COMPACT_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_, WM = WM_, WNQ = WNQ_;
  static constexpr int STAGES = STAGES_, RESIDENT = RESIDENT_, KSPLIT = KSPLIT_;
  static constexpr int GROUP = WARPS_M * WARPS_N * 32;  // threads that share a ring
  static_assert(KSPLIT_ == 1 || GROUP == 32 || KSPLIT_ <= 15,
                "a split group of several warps has a named barrier of its own");
  static constexpr int BK = BK_, CH = BK_ / 16;  // 16-byte chunks of a row
  static_assert(BK_ == 64 || BK_ == 128, "tile_offset covers these");
  static constexpr int THREADS = GROUP * KSPLIT;
  static constexpr int BM = WARPS_M * WM * 16;
  static constexpr int WQ = WARPS_N * WNQ * 8;
  static constexpr int BROWS = MAX_LIMBS * WQ;  // key rows of a stage
  static constexpr int WLEN = BK + WQ;          // bytes of a compact window
  static constexpr int WWORDS = WLEN / 4, WCH = WLEN / 16;
  static constexpr int W = window_stride(WLEN);
  static constexpr int LIMB_BYTES = 4 * W * 4;  // four copies of one limb's window
  static_assert(!COMPACT_ || (WQ % 16 == 0 && WNQ_ % 2 == 0 && STAGES_ >= 3),
                "a window starts on a 16-byte chunk; the copies are made a stage ahead");
  static constexpr int KEY_BYTES = COMPACT_ ? MAX_LIMBS * LIMB_BYTES : BROWS * BK;
  static constexpr int STAGE_BYTES = BM * BK + KEY_BYTES;
  static constexpr int SMEM = KSPLIT * STAGES * STAGE_BYTES;
  static constexpr int A_PER = BM * CH / GROUP;  // 16-byte chunks a thread loads
  static constexpr int B_CHUNKS = COMPACT_ ? MAX_LIMBS * WCH : BROWS * CH;
  static constexpr int B_PER = (B_CHUNKS + GROUP - 1) / GROUP;
  static_assert(A_PER * GROUP == BM * CH, "digit chunks must split evenly");
  static_assert(COMPACT_ || B_PER * GROUP == B_CHUNKS, "key chunks must split evenly");
  static_assert((KSPLIT - 1) * WM * WNQ * MAX_LIMBS * 4 * GROUP * 4 <= SMEM,
                "the groups' sums pass through the ring");
};

// Barrier of the threads that share a ring: the whole block, one warp, or
// (a split group of several warps) the named barrier 1 + grp.
template <class T>
__device__ __forceinline__ void group_sync(int grp) {
  if constexpr (T::KSPLIT == 1) {
    __syncthreads();
  } else if constexpr (T::GROUP == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + grp), "n"(T::GROUP) : "memory");
  }
}

template <class T>
__device__ __forceinline__ void gemm_tile(uint32_t* acc, const int8_t* __restrict__ key_step,
                                          const int8_t* dig, const Geom& g,
                                          int mt, int j, int poly, int qt,
                                          unsigned char* smem) {
  constexpr int WARPS_M = T::WARPS_M, WM = T::WM, WNQ = T::WNQ, STAGES = T::STAGES;
  constexpr int BK = T::BK, CH = T::CH, KS = T::KSPLIT;
  // stages in flight beyond the one that multiplies: the compact producer
  // works on stage c + 1 while stage c multiplies, so it waits one earlier
  constexpr int AHEAD = T::COMPACT ? STAGES - 3 : STAGES - 2;
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
  int b_x[T::COMPACT ? T::B_PER : 1];  // compact: the chunk's byte offset in its window
  const int twoN = 2 * N;
#pragma unroll
  for (int u = 0; u < T::B_PER; ++u) {
    const int cid = tid + u * T::GROUP;
    if constexpr (T::COMPACT) {
      // chunk cid % WCH of the window of limb cid / WCH; b_src is row 0 of
      // that limb column's reversed lines (ncols, R, 2N)
      const int limb = cid / T::WCH, x = cid - limb * T::WCH;
      b_ok[u] = cid < T::B_CHUNKS && limb < nl;
      b_src[u] = key_step + (size_t)(col0 + (b_ok[u] ? limb : 0)) * g.R * twoN;
      b_x[u] = x * 16;
      b_dst[u] = (uint32_t)(T::BM * BK + limb * T::LIMB_BYTES + x * 16);
    } else {
      const int row = cid / CH, ch = cid % CH;
      const int limb = row / T::WQ, q = row - limb * T::WQ;
      b_ok[u] = limb < nl;
      b_src[u] = key_step + ((size_t)(col0 + (b_ok[u] ? limb : 0)) * bs + q0 + q) * Rbs + ch * 16;
      b_dst[u] = (uint32_t)(T::BM * BK) + tile_offset<BK>(row, ch);
    }
  }

  // the group's c-th stage is stage kc = grp + c * KS of the reduction
  const int nkg = (nk - grp + KS - 1) / KS;
  auto load = [&](int c) {
    const int kc = grp + c * KS;
    const int i = kc / nk_i, kk = (kc - i * nk_i) * BK;
    const uint32_t st = sbase + (uint32_t)((c % STAGES) * T::STAGE_BYTES);
#pragma unroll
    for (int u = 0; u < T::A_PER; ++u)
      cp_async16(st + a_dst[u], a_src[u] + (size_t)kc * BK, a_bytes[u]);
    if constexpr (T::COMPACT) {
      // the stage is digits u0..u0+BK-1 of line r; coefficient t's key row is
      // rev[(u0 - t) mod 2N ..], so the tile's rows lie in the window that
      // starts WQ bytes before (u0 - t0), t0 = j*bs + q0, whole 16-byte
      // chunks of the line, each wrapped mod 2N
      const int r = kk / bs, u0 = i * bs + kk - r * bs;
      const int base = u0 - j * bs - q0 - T::WQ;
#pragma unroll
      for (int u = 0; u < T::B_PER; ++u)
        if (b_ok[u])
          cp_async16(st + b_dst[u], b_src[u] + (size_t)r * twoN + ((base + b_x[u]) & (twoN - 1)),
                     16);
    } else {
      const int m = i >= j ? i - j : i - j + g.D;
      const size_t boff = (size_t)m * mblock + kk;
#pragma unroll
      for (int u = 0; u < T::B_PER; ++u)
        if (b_ok[u]) cp_async16(st + b_dst[u], b_src[u] + boff, 16);
    }
  };
  // compact: copies 1..3 of every limb's window of the group's stage c, copy
  // s being the window shifted by s bytes: word w of it is bytes 4w+s..4w+s+3
  // (its last word, which runs past the window, is never read)
  auto shift_copies = [&](int c) {
    uint32_t* win = reinterpret_cast<uint32_t*>(
        smem + (size_t)(grp * STAGES + c % STAGES) * T::STAGE_BYTES + T::BM * BK);
    for (int it = tid; it < nl * T::WWORDS; it += T::GROUP) {
      const int limb = it / T::WWORDS, w = it - limb * T::WWORDS;
      uint32_t* p = win + limb * (4 * T::W) + w;
      const uint32_t lo = p[0], hi = w + 1 < T::WWORDS ? p[1] : 0u;
#pragma unroll
      for (int s = 1; s < 4; ++s) p[s * T::W] = __funnelshift_r(lo, hi, 8 * s);
    }
  };

  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int wrow0 = wm * WM * 16, wq0 = wn * WNQ * 8;
  const int lrow = lane & 7, lmat = lane >> 3;
  // compact: this thread's key fragment of coefficient group qg = 0, k32 step
  // 0, first half. Its coefficient is tl = wq0 + lane/4 of the tile, its four
  // bytes start at 4*(lane%4) of the step, so in the window they start at
  // byte a = WQ - tl + 4*(lane%4): word a/4 of copy a%4. Group qg lies 8*qg
  // bytes before, k32 step ks 32*ks after, the second half 16 after.
  const int frag_a = T::WQ - wq0 - (lane >> 2) + 4 * (lane & 3);
  const int frag_w = (frag_a & 3) * T::W + (frag_a >> 2);

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
  if constexpr (T::COMPACT) {
    cp_async_wait<STAGES - 2>();  // stage 0 has landed
    group_sync<T>(grp);
    shift_copies(0);
  }
  for (int c = 0; c < nkg; ++c) {
    // this thread's copies of stage c (compact: of stage c + 1) have landed
    cp_async_wait<AHEAD>();
    // everyone's of the group have, and stage c-1 is consumed
    group_sync<T>(grp);
    if (c + STAGES - 1 < nkg) load(c + STAGES - 1);
    cp_async_commit();
    if constexpr (T::COMPACT) {
      if (c + 1 < nkg) shift_copies(c + 1);  // read after the next barrier
    }
    const uint32_t sA = sbase + (uint32_t)((c % STAGES) * T::STAGE_BYTES);
    const uint32_t sB = sA + (uint32_t)(T::BM * BK);
    const uint32_t* bw = reinterpret_cast<const uint32_t*>(
        smem + (size_t)(grp * STAGES + c % STAGES) * T::STAGE_BYTES + T::BM * BK) + frag_w;
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
      if constexpr (T::COMPACT) {
        // key fragments straight from the shifted windows: two aligned words.
        // (Keeping the words that groups two apart and the two halves share
        // in registers cost more registers than it saved loads: 474 against
        // 353 ms at the 8-party set, B = 256, on an H100 at 700 W.)
#pragma unroll
        for (int qg = 0; qg < WNQ; ++qg)
#pragma unroll
          for (int lim = 0; lim < MAX_LIMBS; ++lim)
            if (lim < nl) {
              const uint32_t b0 = bw[lim * (4 * T::W) + 8 * ks - 2 * qg];
              const uint32_t b1 = bw[lim * (4 * T::W) + 8 * ks - 2 * qg + 4];
#pragma unroll
              for (int mi = 0; mi < WM; ++mi) mma_s8(sum[mi][qg][lim], af[mi], b0, b1);
            }
      } else if constexpr (WNQ % 2 == 0) {
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

  // one step's key: D blocks of the expanded kernel layout, or the compact
  // lines (ncols, R, 2N)
  const size_t step_bytes =
      T::COMPACT ? (size_t)g.ncols * g.R * 2 * N : (size_t)g.D * g.ncols * bs * Rbs;
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

// The geometry of a launch from the wrapper's arguments. The limb columns of
// one polynomial must be consecutive, at most four, and every polynomial must
// have one; false otherwise.
static bool fill_geom(Geom& g, int B, int n, int N, int bs, int C, int l, int lb,
                      unsigned int offset, unsigned int mu, int ncols, const int* col_poly,
                      const int* col_shift) {
  if (ncols < 1 || ncols > MAX_COLS || C < 1 || C > MAX_COLS || B < 1 || bs < 1 || N % bs)
    return false;
  g.B = B; g.n = n; g.N = N; g.bs = bs; g.nb = N / bs; g.D = 2 * N / bs; g.C = C;
  g.R = l * C; g.l = l; g.lb = lb; g.ncols = ncols; g.offset = offset; g.mu = mu;
  for (int i = 0; i < MAX_COLS; ++i) {
    g.poly_col[i] = 0; g.poly_nl[i] = 0;
    g.col_shift[i] = i < ncols ? col_shift[i] : 0;
  }
  for (int ci = 0; ci < ncols; ++ci) {
    const int p = col_poly[ci];
    if (p < 0 || p >= C) return false;
    if (g.poly_nl[p] == 0) g.poly_col[p] = ci;
    if (g.poly_col[p] + g.poly_nl[p] != ci || g.poly_nl[p] == MAX_LIMBS)
      return false;  // not consecutive, or more than four
    ++g.poly_nl[p];
  }
  for (int p = 0; p < C; ++p)
    if (g.poly_nl[p] == 0) return false;
  return true;
}
