// The GEMM-phase tile of blind_rotate_sel.cu above 64 gates: warpgroup MMAs
// (wgmma) whose register operand is the key, built on the SM from the compact
// lines, and whose shared-memory operand is the digit rows, fed by a TMA ring.
//
// What bounds the mma.sync tiles of rotate_gemm.cuh here. At the 8-party set,
// B = 256, a step is 34.4 G int8 operations (17.4 us at the card's peak)
// against 64 MB of digit rows landed from L2 (9.3 us at the 6.9 TB/s that
// rotate_wgmma.cuh draws): the MMAs set the pace. mma.sync.m16n8k32 issues
// about one MMA every 3 clocks where the tensor cores take 1, and the tile
// passes a block-wide barrier every 128-byte stage: 59.5 us a step (257 ms a
// rotate of 4,320 steps on an H100 at 700 W). This tile:
//   * A block computes 64 gates x 64 coefficients x 4 limb columns, as T3
//     does (128 tiles a step at B = 256 on 132 SMs). Per k32 step and limb,
//     one wgmma.m64n64k32 s8 x s8 -> s32 with M = 64 coefficients of the
//     limb column and N = the 64 gates, each limb with its own accumulator.
//   * A (registers) is the key. Entry (t, u) of a stage is rev[(u0 + u - t0 -
//     t) mod 2N]: the Toeplitz window of BK + WQ = 192 bytes a limb that
//     rotate_gemm.cuh's compact tiles read, with its three byte-shifted
//     copies, so that every 4 bytes a fragment holds are one aligned word of
//     copy (u0 - t) mod 4. wgmma's register fragment of A for 8-bit types is,
//     warp by warp, mma.m16n8k32's A layout; the tile names its rows so that
//     row 16w + n + 8h is coefficient 8w + n + 32h. A row's second half (h =
//     1) then holds, at k32 step ks, the bytes its first half held at ks - 1
//     (32 coefficients on is 32 bytes back), so a thread loads two words a
//     k32 step and limb and keeps two: 20 loads a stage and limb, not 32.
//   * B (shared memory) is the digit rows (gate, k), K-major, one box of 64
//     rows x 128 bytes a stage, 128-byte swizzled, brought by TMA, which
//     fills rows past B with zeros.
//   * Two consumer warpgroups split the limbs: warpgroup w multiplies every
//     stage by limb columns 2w and 2w + 1 (64 accumulator registers a
//     thread). At the tile's end each folds its limbs into 32 words, sum <<
//     shift, and warpgroup 1 hands them to warpgroup 0 through 16 KB of
//     shared memory, which adds them into the accumulator (16 words read
//     before any of them is written). Splitting the stages instead,
//     each warpgroup with all four limbs, needs 128 accumulator registers,
//     and with 9-12 warps an SM three share a quarter of the register file,
//     168 registers a thread: ptxas serialised the wgmmas.
//   * Four producer warps keep a ring of 8 stages full, warp w the stages
//     it = w mod 4: per stage one TMA box of digits and, by cp.async,
//     the 12 16-byte chunks of each limb's window (each wrapped mod 2N). LAG
//     of its stages later, once those chunks have landed, the warp writes
//     copies 1..3 of each window (a funnel shift a word, window_stride words
//     apart) and arrives on the stage's full barrier, on which TMA completes
//     its bytes too. Each consumer warpgroup arrives on the stage's empty
//     barrier once the MMAs that read it are done: no block-wide barrier a
//     stage. (One producer warp, its loads and copies one stage after the
//     other, held a step at 51 us; four take that chain off the path. 8,
//     12 or 16 stages, LAG 1-3, are within 3% of each other.)
//   * One commit group a k32 step; a warpgroup waits until at most two are
//     in flight before it loads the next words, since the words it keeps
//     are read by two groups.
// Everything else is the frame of rotate_gemm.cuh and rotate_wgmma.cuh: one
// cooperative launch a rotate, the digit phase and a grid barrier after each
// phase, accumulators and int8 digit rows in global memory (L2), the async-
// proxy fences around the digit phase (TMA reads rows that generic stores
// wrote). The block is 12 warps, one an SM.
// Measured on an H100 80GB HBM3 at 700 W (tools/rotate_bench.py), 8 parties:
// 146 ms a rotate at B = 256 (33.8 us a step, of which the digit phase and
// its barriers are 4.9 us; T3 257 ms), 550 ms at B = 1024 (T4 808 ms); 4
// parties, B = 256: 57 ms (T3 95 ms). What bounds it next is shared memory:
// a stage reads 32 KB of digit rows into the MMAs and 20 KB of key words
// into registers, and TMA writes 8 KB, about 500 clocks at 128 bytes a
// clock, against 512 clocks of MMAs at the tensor cores' peak.
// Sums are exact int32 as in every tile: R*N*2^(lb-1)*128 < 2^31.
#pragma once

#include "rotate_wgmma.cuh"  // mbarriers, TMA, descriptors, wgmma sync (and rotate_gemm.cuh)

namespace sw {

// The tile; COMPACT names the key it reads (the compact lines), so that a
// trace of the kernel files it under the compact-key rotate.
template <bool COMPACT_, int STAGES_, int NPROD_, int LAG_>
struct WgTile {
  static_assert(COMPACT_, "the tile makes its key operand from the compact lines");
  static constexpr int STAGES = STAGES_;
  static constexpr int BM = 64;   // gates: the wgmma's N
  static constexpr int WQ = 64;   // coefficients of a limb column: the wgmma's M
  static constexpr int BK = 128;  // reduction bytes a stage
  static constexpr int CONSUMERS = 2;  // warpgroups, LIMBS limb columns each
  static constexpr int LIMBS = MAX_LIMBS / CONSUMERS;
  static constexpr int NPROD = NPROD_;  // producer warps, warp w the stages w mod NPROD
  static constexpr int THREADS = CONSUMERS * 128 + NPROD * 32;
  static constexpr int DIG_BYTES = BM * BK;  // a stage's digit box
  static constexpr int WLEN = BK + WQ, WWORDS = WLEN / 4, WCH = WLEN / 16;
  static constexpr int W = window_stride(WLEN);
  static constexpr int LIMB_BYTES = 4 * W * 4;  // four copies of one limb's window
  static constexpr int KEY_BYTES = MAX_LIMBS * LIMB_BYTES;
  static constexpr int JOIN_BYTES = WQ * BM * 4;  // warpgroup 1's words of a tile
  static constexpr int LAG = LAG_;  // a producer's stages from a window's load to its copies
  static_assert(LAG * NPROD < STAGES, "a stage's copies are made before its slot comes round");
  // digit boxes (1024-aligned for the swizzle), key windows, the join, then a
  // full and an empty mbarrier a stage; 1024 bytes to align the start
  static constexpr int SMEM = STAGES * (DIG_BYTES + KEY_BYTES) + JOIN_BYTES + 1024 + 16 * STAGES;
};

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// the two consumer warpgroups (warps 0-7), named barrier 1
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// d += A (64 x 32 bytes, registers) x B (64 x 32 bytes at db)^T, int8 -> int32.
// Thread t of the warpgroup holds A rows 16*(t/32) + (t%32)/4 (+8), bytes
// 4*(t%4).. (+16) in a[0] (a[1] for the second row, a[2], a[3] 16 bytes on),
// and d rows likewise, columns 8*i + 2*(t%4) (+1): d[4i], d[4i+1] in the
// first row, d[4i+2], d[4i+3] in the second.
__device__ __forceinline__ void wgmma_64_rs(int (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{ %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " { %32, %33, %34, %35 }, %36, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1)
      : "memory");
}

}  // namespace sw

template <class T>
__global__ void __launch_bounds__(T::THREADS, 1)
    blind_rotate_kernel_sel_wgmma(uint32_t* acc, const int32_t* __restrict__ acc_in,
                                  const int32_t* __restrict__ barb,
                                  const int32_t* __restrict__ bara,
                                  const int8_t* __restrict__ key, int8_t* dig,
                                  const __grid_constant__ CUtensorMap dmap, Geom g) {
  using namespace wg;
  constexpr int STAGES = T::STAGES, BM = T::BM, WQ = T::WQ, BK = T::BK, W = T::W;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int B = g.B, N = g.N, C = g.C, bs = g.bs, twoN = 2 * N;
  const int CN = C * N, Rbs = g.R * bs, K = g.nb * Rbs;
  const int nk_i = Rbs / BK, nk = g.nb * nk_i;
  const int gtid = blockIdx.x * T::THREADS + threadIdx.x, gthreads = gridDim.x * T::THREADS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the ring, 1024-byte aligned: digit boxes, key windows, the join, then
  // full[STAGES] and empty[STAGES]
  const uint32_t ring = (smem_u32(smem) + 1023u) & ~1023u;
  unsigned char* const ring_p = smem + (ring - smem_u32(smem));
  const uint32_t keys = ring + STAGES * T::DIG_BYTES;
  uint32_t* const keys_p = reinterpret_cast<uint32_t*>(ring_p + STAGES * T::DIG_BYTES);
  uint32_t* const join_p = keys_p + STAGES * T::KEY_BYTES / 4;
  const uint32_t full0 = keys + STAGES * T::KEY_BYTES + T::JOIN_BYTES, empty0 = full0 + STAGES * 8;
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 2);              // the producer's expect_tx, then its copies
      mbar_init(empty0 + 8 * st, T::CONSUMERS);  // each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  for (unsigned e = gtid; e < (unsigned)(B * CN); e += gthreads) {
    const int gate = (int)(e / (unsigned)CN);
    acc[e] = init_acc_word(acc_in, barb, gate, (int)e - gate * CN, N, C, g.mu);
  }
  grid.sync();

  const uint32_t lmask = (1u << g.lb) - 1u, half = 1u << (g.lb - 1);
  const int quads = CN / 4, nquad = N / 4;
  const int MT = (B + BM - 1) / BM, QT = bs / WQ;
  const int tiles = MT * g.nb * C * QT;
  const size_t step_bytes = (size_t)g.ncols * g.R * twoN;
  uint32_t it = 0;  // the ring's position, the same sequence in every role

  for (int s = 0; s < g.n; ++s) {
    // digit phase, as blind_rotate_kernel's phase 1
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
    asm volatile("fence.proxy.async.global;\n" ::: "memory");  // the TMA reads them
    grid.sync();

    const int8_t* key_step = key + (size_t)s * step_bytes;
    if (warp >= T::CONSUMERS * 4) {
      // a producer warp: the stages it = pw mod NPROD of every tile
      const int pw = warp - T::CONSUMERS * 4;
      // copies 1..3 of every limb's window of the stage at ring position p,
      // copy j being the window shifted by j bytes (its last word runs past
      // the window and is never read); then lane 0 arrives on the stage's
      // full barrier, which also waits for the TMA's bytes
      auto shift_copies = [&](uint32_t p) {
        const uint32_t st = p % STAGES;
        uint32_t* win = keys_p + st * (T::KEY_BYTES / 4);
        static_assert(MAX_LIMBS * T::WWORDS % 32 == 0, "whole words a lane");
#pragma unroll
        for (int u = 0; u < MAX_LIMBS * T::WWORDS / 32; ++u) {
          const int e = lane + 32 * u, limb = e / T::WWORDS, w = e - limb * T::WWORDS;
          uint32_t* q = win + limb * (4 * W) + w;
          const uint32_t lo = q[0], hi = w + 1 < T::WWORDS ? q[1] : 0u;
#pragma unroll
          for (int j = 1; j < 4; ++j) q[j * W] = __funnelshift_r(lo, hi, 8 * j);
        }
        __syncwarp();  // every lane's copies, released by lane 0's arrival
        if (lane == 0) sw::mbar_arrive(full0 + 8 * st);
      };
      asm volatile("fence.proxy.async.global;\n" ::: "memory");
      int pend = 0;       // own stages whose windows are loading and not yet copied
      uint32_t last = 0;  // the last of them
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int mt = tile % MT;
        int nt = tile / MT;
        const int qt = nt % QT;
        nt /= QT;
        const int poly = nt % C, j = nt / C;
        // limb 0's R reversed lines of the step, (ncols, R, 2N)
        const int8_t* lines = key_step + (size_t)g.poly_col[poly] * g.R * twoN;
        for (int kc = 0; kc < nk; ++kc, ++it) {
          if ((int)(it % T::NPROD) != pw) continue;
          const uint32_t st = it % STAGES, ph = (it / STAGES) & 1;
          mbar_wait(empty0 + 8 * st, ph ^ 1);
          if (lane == 0) {
            mbar_expect_tx(full0 + 8 * st, T::DIG_BYTES);
            tma_load(ring + st * T::DIG_BYTES, &dmap, full0 + 8 * st, kc * BK, mt * BM);
          }
          // the stage is digits u0..u0+BK-1 of line r; coefficient t's key
          // row is rev[(u0 - t) mod 2N ..], so the tile's rows lie in the
          // window that starts WQ bytes before u0 - t0, t0 = j*bs + qt*WQ
          const int i = kc / nk_i, kk = (kc - i * nk_i) * BK;
          const int r = kk / bs, u0 = i * bs + kk - r * bs;
          const int base = u0 - j * bs - qt * WQ - WQ;
          for (int e = lane; e < MAX_LIMBS * T::WCH; e += 32) {
            const int limb = e / T::WCH, x = e - limb * T::WCH;
            cp_async16(keys + st * T::KEY_BYTES + limb * T::LIMB_BYTES + x * 16,
                       lines + ((size_t)limb * g.R + r) * twoN + ((base + 16 * x) & (twoN - 1)),
                       16);
          }
          cp_async_commit();
          last = it;
          if (++pend > T::LAG) {
            cp_async_wait<T::LAG>();  // this lane's chunks of own stage it - LAG*NPROD
            __syncwarp();             // and every lane's
            shift_copies(it - T::LAG * T::NPROD);
            --pend;
          }
        }
      }
      cp_async_wait<0>();
      __syncwarp();
      for (; pend > 0; --pend) shift_copies(last - (pend - 1) * T::NPROD);
    } else {
      // a consumer warpgroup: limb columns LIMBS*wgi.. of each tile, every
      // stage. Row 16*w + n + 8*h of the wgmma (warp w, n = (tid%32)/4) is
      // the tile's coefficient tl + 32*h, tl = 8*w + n; bytes 4*(tid%4).. of
      // a k32 step of row tl lie at byte a = WQ - tl + 4*(tid%4) of the
      // window: word a/4 of copy a%4, plus 8 a k32 step
      const int wgi = warp >> 2, tid = threadIdx.x & 127;
      const int tl = 8 * (tid >> 5) + ((tid & 31) >> 2);
      const int frag_a = WQ - tl + 4 * (tid & 3);
      const int frag_w = wgi * T::LIMBS * (4 * W) + (frag_a & 3) * W + (frag_a >> 2);
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int mt = tile % MT;
        int nt = tile / MT;
        const int qt = nt % QT;
        nt /= QT;
        const int poly = nt % C, j = nt / C;
        int d[T::LIMBS][32];
#pragma unroll
        for (int lim = 0; lim < T::LIMBS; ++lim)
#pragma unroll
          for (int e = 0; e < 32; ++e) d[lim][e] = 0;
        // per k32 step ks the words of row tl (bytes +0, +16), and row tl +
        // 32's at step 0 (at the others: the previous step's of row tl)
        uint32_t lo[BK / 32][T::LIMBS][2], first[T::LIMBS][2];
        for (int kc = 0; kc < nk; ++kc) {
          const uint32_t p = it + kc, st = p % STAGES;
          mbar_wait(full0 + 8 * st, (p / STAGES) & 1);
          const uint32_t* bw = keys_p + st * (T::KEY_BYTES / 4) + frag_w;
          const uint64_t db = smem_desc(ring + st * T::DIG_BYTES);
#pragma unroll
          for (int ks = 0; ks < BK / 32; ++ks) {
            // the words loaded now were read by the groups ks and ks + 1 of
            // the previous stage, two groups back at most; once two groups
            // of this stage are issued, the previous stage's last is done
            wgmma_wait<2>();
            if (ks == 2 && kc > 0 && tid == 0) sw::mbar_arrive(empty0 + 8 * ((p - 1) % STAGES));
#pragma unroll
            for (int lim = 0; lim < T::LIMBS; ++lim) {
              const uint32_t* f = bw + lim * (4 * W) + 8 * ks;
              lo[ks][lim][0] = f[0];  // row tl
              lo[ks][lim][1] = f[4];  // row tl, 16 bytes on
              if (ks == 0) {
                first[lim][0] = f[-8];  // row tl + 32: 32 bytes back
                first[lim][1] = f[-4];
              }
            }
            wgmma_fence();
#pragma unroll
            for (int lim = 0; lim < T::LIMBS; ++lim) {
              const uint32_t(&prev)[2] = ks ? lo[ks ? ks - 1 : 0][lim] : first[lim];
              const uint32_t a[4] = {lo[ks][lim][0], prev[0], lo[ks][lim][1], prev[1]};
              sw::wgmma_64_rs(d[lim], a, db + 2 * ks);
            }
            wgmma_commit();
          }
        }
        wgmma_wait<0>();
        if (tid == 0) sw::mbar_arrive(empty0 + 8 * ((it + nk - 1) % STAGES));

        // fold the limbs: word (coefficient row, gate) of the tile
        const int col0 = g.poly_col[poly] + wgi * T::LIMBS;
        uint32_t v[32];
#pragma unroll
        for (int e = 0; e < 32; ++e) v[e] = 0;
#pragma unroll
        for (int lim = 0; lim < T::LIMBS; ++lim) {
          const uint32_t sh = g.col_shift[col0 + lim];
#pragma unroll
          for (int e = 0; e < 32; ++e) v[e] += (uint32_t)d[lim][e] << sh;
        }
        if (wgi == 1) {
#pragma unroll
          for (int e = 0; e < 32; ++e) join_p[e * 128 + tid] = v[e];
        }
        sw::consumers_sync();
        if (wgi == 0) {
          // coefficients tl and tl + 32, gates 8*i + 2*(tid%4), +1; 16 words
          // are read before any of them is written, so that the loads are in
          // flight at once (one after the other, a store between, they were
          // 32 round trips to L2 a tile)
          uint32_t* row = acc + (size_t)poly * N + j * bs + qt * WQ + tl;
          constexpr int PART = 16;  // words in flight: all 32 made ptxas spill
#pragma unroll
          for (int e0 = 0; e0 < 32; e0 += PART) {
            uint32_t old[PART];
#pragma unroll
            for (int e = e0; e < e0 + PART; ++e) {
              const int gate = mt * BM + 8 * (e >> 2) + 2 * (tid & 3) + (e & 1);
              old[e - e0] = gate < B ? __ldcg(row + (size_t)gate * CN + 32 * ((e >> 1) & 1)) : 0u;
            }
#pragma unroll
            for (int e = e0; e < e0 + PART; ++e) {
              const int gate = mt * BM + 8 * (e >> 2) + 2 * (tid & 3) + (e & 1);
              if (gate < B)
                row[(size_t)gate * CN + 32 * ((e >> 1) & 1)] =
                    old[e - e0] + v[e] + join_p[e * 128 + tid];
            }
          }
        }
        sw::consumers_sync();  // the join is read before the next tile writes it
        it += nk;
      }
    }
    grid.sync();
  }
}

namespace sw {

// The launch: the tensor map of the digit rows (B x K, boxes of 64 rows x
// 128 bytes), the grid cut to what is co-resident (one block an SM), one
// cooperative launch. Every polynomial must have MAX_LIMBS limb columns.
template <class T>
static cudaError_t launch(uint32_t* acc, const int32_t* acc_in, const int32_t* barb,
                          const int32_t* bara, const int8_t* key, int8_t* dig, Geom g,
                          int blocks, int* grid_used, cudaStream_t stream) {
  if (g.bs % T::BK || g.bs % T::WQ) return cudaErrorInvalidValue;
  for (int p = 0; p < g.C; ++p)
    if (g.poly_nl[p] != MAX_LIMBS) return cudaErrorInvalidValue;
  CUtensorMap dmap;
  if (!wg::encode(&dmap, dig, (uint64_t)g.nb * g.R * g.bs, (uint64_t)g.B, T::BM))
    return cudaErrorInvalidValue;
  auto kernel = blind_rotate_kernel_sel_wgmma<T>;
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
  // the grid barrier needs every block resident at once
  const int grid = blocks < sms ? blocks : sms;
  if (grid_used != nullptr) *grid_used = grid;
  void* args[] = {&acc, &acc_in, &barb, &bara, &key, &dig, &dmap, &g};
  return cudaLaunchCooperativeKernel((void*)kernel, dim3(grid), dim3(T::THREADS), args, T::SMEM,
                                     stream);
}

}  // namespace sw
