// The latency tile of blind_rotate.cu: the smallest batches over the
// expanded key (up to 3 gates, where it beats the 16 x 8 tile),
// key-stationary, one grid barrier a step.
//
// What bounds a small batch. A step multiplies a few digit rows by the
// step's key, D*ncols*bs*R*bs bytes, of which the pairs (digit block i,
// output block j) read the 2*nb - 1 blocks m = (i - j) mod D: 11.8 MB at
// tfhe_128, 3.5 us at the device-memory rate, against 0.2 MOP. An
// output-stationary tile (a gate tile x one output block's coefficients)
// reads every key block once for each output block it pairs with, about
// 4.3 times a step into the SMs, after a barrier that ended the digit
// phase, and so starts its key stream cold every step. This tile instead:
//   * Key-stationary. The grid's blocks own the step's key boxes: block b
//     owns key block m, polynomial `poly` and `units` x 8 output
//     coefficients q0.. (a multiple of 32), every limb column of the
//     polynomial, the same box in every step. Every key byte lands in one SM
//     once a step. A pair p of the box multiplies digit block i = i0 + p
//     into output block j = i - d, d = i - j the offset of block m, np = nb
//     - |d| pairs; the digit rows are the pairs x the B gates (row p*B + gate).
//   * Each block builds the digit rows of its pairs itself from the
//     accumulator (read from L2, each sector once a warp) into shared
//     memory: no digit phase of the grid, no barrier after one. The blocks
//     of one (m, poly) group read the same accumulator words, so each added
//     gate costs a step another L2 round of them: at 4 gates the 16 x 8 tile
//     is faster at the fast set and the 2-party 3gen set on an H100.
//   * A producer warp streams each step's box by TMA into a ring of `slots`
//     box-steps with full/empty mbarriers. The key does not depend on the
//     accumulator, so the producer runs up to `slots` steps ahead of the
//     chain and waits for ring slots only, never for the grid barrier. It
//     spreads a box's copies over the step at the grid's share of the
//     device-memory rate (`pace_ns`, from the launch plan): a whole box-step
//     from every SM at once queued the chain's own L2 traffic behind it (3.2
//     against 0.8 us before a block's arrival at tfhe_128, B = 1, on an H100).
//   * Warpgroup MMAs (wgmma.m64nNk32 s8): A is the key, 64 rows of 128
//     reduction bytes a chunk, 32 coefficients x a pair of limb columns, row
//     16w + 8l + c the coefficient 8w + c of limb l (one 3-D TMA box of 8
//     coefficients x 2 limbs a w); B is the digit rows, N = 8..32 of them.
//     A thread's accumulators of the two limb pairs hold all four limbs of
//     its coefficients, folded (sum << shift) in registers. Two consumer
//     warpgroups split the digit rows, or the reduction chunks where the
//     rows are one tile. (mma.sync's m16n8k32, 16 rows of which a gate used
//     8, kept the SM's tensor cores busy 1.9 us a step at B = 1.)
//   * Exact combination: an output word sums the partials of up to nb
//     blocks, added with red.global.add.u32 (exact mod 2^32 in any order).
//     The accumulators ping-pong: step s reads P[s%2] and adds into
//     P[(s+1)%2], which holds the accumulator of step s-1, so a block adds
//     its partial of step s-1 again with that of step s (kept in shared
//     memory, per thread). Step s+1's adds never meet step s's reads, and
//     one grid barrier a step is enough: the consumers' own, on a counter in
//     the scratch that block 0 zeroes before the launch's one grid sync.
//
// The launch plan (ops/cuda_rotate.latency_layout) chooses units, slots and
// the pace; the launcher derives the shared-memory offsets from them and
// refuses a plan whose bytes it does not reproduce.
#pragma once

#include "rotate_wgmma.cuh"  // the mbarrier, TMA and wgmma helpers, and rotate_gemm.cuh

namespace lat {

constexpr int CONSUMERS = 8;                   // warps: two warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 32;  // and the producer warp
constexpr int UNIT = 8;                        // coefficients of a box unit
constexpr int CT = 32;                         // coefficients of an A tile
constexpr int BK = 128;                        // bytes of a reduction chunk
constexpr int TILE_BYTES = 64 * BK;            // an A tile: 32 coefficients x 2 limbs
constexpr int MAX_SLOTS = 4;
constexpr int QPT = 4;                         // digit quads a thread builds at once
constexpr int MAX_B = 3;                       // gates a launch takes

// N of a block's wgmma tiles over `rows` digit rows (at most 64): two tiles
// (one a warpgroup) of the least of 8, 16, 32 that halves the rows
__host__ __device__ __forceinline__ int n_tile(int rows) {
  int nt = 8;
  while (nt < 32 && 2 * nt < rows) nt *= 2;
  return nt;
}

// What the launcher derives from the geometry, B and the launch plan's
// layout; shared-memory offsets from the 1024-aligned base.
struct Plan {
  int units;      // units of UNIT coefficients in a block's box, a multiple of 4
  int per_group;  // blocks of one (m, poly) group: bs / (UNIT * units)
  int slots;      // ring slots, one box-step each
  int mtp;        // digit rows the largest pair set's tiles read (>= nb * B)
  uint32_t box_bytes, dig_off, prev_off, bar_off, smem;
  uint32_t pace_ns;  // after each A tile the producer copies
};

// layout = {units, slots, shared-memory bytes, pace_ns} of the launch plan;
// false where the tile does not take the geometry or the bytes differ
static bool make_plan(const Geom& g, const int* layout, Plan& p) {
  const int rbs = g.R * g.bs, u = layout[0];
  if (rbs % BK || g.B > MAX_B || g.nb * g.B > 64 || u < CT / UNIT || u % (CT / UNIT) ||
      g.bs % (u * UNIT) || layout[1] < 1 || layout[1] > MAX_SLOTS || layout[3] < 0)
    return false;
  const int nkc = rbs / BK, rows = g.nb * g.B, nt = n_tile(rows), tiles = (rows + nt - 1) / nt;
  p.units = u;
  p.per_group = g.bs / (u * UNIT);
  p.slots = layout[1];
  p.mtp = tiles * nt;
  p.box_bytes = (uint32_t)(nkc * (u * UNIT / CT) * 2 * TILE_BYTES);
  const int items = u * UNIT / CT * tiles > 2 ? u * UNIT / CT * tiles : 2;
  const uint32_t dig = (uint32_t)(nkc * p.mtp * BK), prev = (uint32_t)(items * nt * 128);
  p.dig_off = p.slots * p.box_bytes;
  p.prev_off = p.dig_off + dig;
  p.bar_off = p.prev_off + prev;
  // 1 KiB to align the ring, a full and an empty mbarrier a slot, two
  // rotations a gate
  p.smem = 1024 + p.bar_off + 16 * p.slots + 8 * MAX_B;
  p.pace_ns = (uint32_t)layout[3];
  return p.smem == (uint32_t)layout[2];
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 32) : "memory");
}

// The grid barrier of the consumer warps: the counter counts every block's
// arrivals since the launch began; step s waits for gridDim.x * (s + 1). The
// arrival releases what the block's threads wrote before the CTA barrier,
// the spin acquires what every block wrote before its arrival.
__device__ __forceinline__ void step_barrier(unsigned* counter, unsigned target) {
  consumer_sync();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter) : "memory");
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(counter) : "memory");
    } while (v < target);
  }
  consumer_sync();
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// the box of the 3-D map at (c0 bytes, c1 coefficients, c2 key columns)
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// d += A (64 x 32 bytes at da) x B (N x 32 bytes at db)^T, int8 -> int32;
// thread t holds rows 16*(t/32) + (t%32)/4 (+8) and columns 8*i + 2*(t%4)
// (+1): d[4i], d[4i+1] in the first row, d[4i+2], d[4i+3] in the second.
template <int N>
__device__ __forceinline__ void wgmma_n(int (&d)[N / 2], uint64_t da, uint64_t db);

#define LAT_WGMMA_HEAD(n) \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" #n ", 0;\n"
template <>
__device__ __forceinline__ void wgmma_n<8>(int (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(LAT_WGMMA_HEAD(6)
               "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 {%0, %1, %2, %3}, %4, %5, p;\n}\n"
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
               : "l"(da), "l"(db), "r"(1)
               : "memory");
}
template <>
__device__ __forceinline__ void wgmma_n<16>(int (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(LAT_WGMMA_HEAD(10)
               "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
               "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
                 "+r"(d[6]), "+r"(d[7])
               : "l"(da), "l"(db), "r"(1)
               : "memory");
}
template <>
__device__ __forceinline__ void wgmma_n<32>(int (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(LAT_WGMMA_HEAD(18)
               "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
               "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
               " %16, %17, p;\n}\n"
               : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
                 "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
                 "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
               : "l"(da), "l"(db), "r"(1)
               : "memory");
}
#undef LAT_WGMMA_HEAD

// What a warpgroup's item needs besides its tile: where its key tiles and
// digit rows are, the rows and pairs, and where the partials go.
struct Item {
  uint32_t key, dig;       // A tile (chunk 0, limb pair 0), digit rows (chunk 0, row n0)
  int part, kparts, nkc;   // reduction chunks part, part + kparts, ..
  uint32_t chunk_a, chunk_b;  // bytes from one chunk to the next: key tiles, digit rows
  int n0, M, B;
  uint32_t* next;          // word (gate 0, poly, coefficient 0 of output block 0)
  int i0, d, C, N, bs, coef;
  uint32_t* kept;          // this thread's partial words of the item
};

// One item: the wgmmas over its chunks, then per digit row r (pair r / B,
// gate r % B) and the thread's coefficient, the four limbs folded, this
// step's and the last step's partial added into the next accumulator.
template <int NT>
__device__ __forceinline__ void run_item(const Item& it, const uint32_t (&shift)[MAX_LIMBS],
                                         const uint32_t (&keep)[MAX_LIMBS]) {
  // narrow tiles: two sums a limb pair (even and odd k32 steps), so that
  // each chain of dependent wgmmas is half as long
  constexpr int PAR = NT <= 16 ? 2 : 1;
  int acc[2 * PAR][NT / 2];
#pragma unroll
  for (int h = 0; h < 2 * PAR; ++h)
#pragma unroll
    for (int r = 0; r < NT / 2; ++r) acc[h][r] = 0;
  wg::wgmma_fence();
  for (int kc = it.part; kc < it.nkc; kc += it.kparts) {
    const uint64_t da = wg::smem_desc(it.key + kc * it.chunk_a);
    const uint64_t db = wg::smem_desc(it.dig + kc * it.chunk_b);
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      // both limb pairs, whatever the polynomial's limbs: a branch around
      // a wgmma makes ptxas serialise them all (a missing pair's sums are
      // masked off below)
      wgmma_n<NT>(acc[(ks % PAR) * 2], da + 2 * ks, db + 2 * ks);
      wgmma_n<NT>(acc[(ks % PAR) * 2 + 1], da + (TILE_BYTES >> 4) + 2 * ks, db + 2 * ks);
    }
  }
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
  if constexpr (PAR == 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < NT / 2; ++r) acc[h][r] += acc[2 + h][r];
  }
  const int tid = threadIdx.x & 127;
#pragma unroll
  for (int i = 0; i < NT / 8; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      // rows 16w + c (limb 2h) and 16w + c + 8 (limb 2h + 1) of tile h
      const uint32_t v = (((uint32_t)acc[0][4 * i + e] << shift[0]) & keep[0]) +
                         (((uint32_t)acc[0][4 * i + 2 + e] << shift[1]) & keep[1]) +
                         (((uint32_t)acc[1][4 * i + e] << shift[2]) & keep[2]) +
                         (((uint32_t)acc[1][4 * i + 2 + e] << shift[3]) & keep[3]);
      uint32_t* kept = it.kept + (2 * i + e) * 128;
      const int r = it.n0 + 8 * i + 2 * (tid & 3) + e;
      if (r < it.M) {
        const int pp = r / it.B, gate = r - pp * it.B;
        atomicAdd(it.next + ((size_t)gate * it.C) * it.N + (it.i0 + pp - it.d) * it.bs + it.coef,
                  v + *kept);
      }
      *kept = v;
    }
}

}  // namespace lat

__global__ void __launch_bounds__(lat::THREADS, 1)
    blind_rotate_kernel_latency(uint32_t* out, const int32_t* __restrict__ acc_in,
                                const int32_t* __restrict__ barb,
                                const int32_t* __restrict__ bara, uint32_t* other,
                                unsigned* counter, const __grid_constant__ CUtensorMap kmap,
                                Geom g, lat::Plan p) {
  using namespace lat;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  const int B = g.B, N = g.N, C = g.C, bs = g.bs, nb = g.nb;
  const int CN = C * N, rbs = g.R * bs, nkc = rbs / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* base = smem_raw + (ring - raw);
  const uint32_t full0 = ring + p.bar_off, empty0 = full0 + 8 * p.slots;
  // the rotation of every gate in this step and the next (bara, mod 2N)
  int* const rot = reinterpret_cast<int*>(base + p.bar_off + 16 * p.slots);

  // this block's box: group (m, poly), coefficients q0 .. q0 + units*8 - 1
  const int group = blockIdx.x / p.per_group, mi = group / C, poly = group - mi * C;
  const int m = mi < nb ? mi : mi + 1;  // block nb pairs with nothing
  const int d = m < nb ? m : m - g.D;   // i - j of every pair
  const int i0 = d > 0 ? d : 0, np = nb - (d > 0 ? d : -d);
  const int ub = blockIdx.x - group * p.per_group;
  const int cts = p.units * UNIT / CT, q0 = ub * p.units * UNIT;
  const int nl = g.poly_nl[poly], col0 = g.poly_col[poly], pairs = (nl + 1) / 2;
  // the items: (A tile, N tile of the digit rows, part of the chunks), dealt
  // to the two warpgroups; with fewer than two tiles they split the chunks
  const int M = np * B, nt = n_tile(M), ntiles = (M + nt - 1) / nt;
  const int kparts = cts * ntiles < 2 ? (nkc < 2 ? nkc : 2) : 1, items = cts * ntiles * kparts;
  // step s reads P[s % 2] and adds into the other; the last lands in out
  uint32_t* const p0 = g.n % 2 ? other : out;
  uint32_t* const p1 = g.n % 2 ? out : other;

  // step s's box into slot s % slots: per chunk, A tile, limb pair and 8
  // coefficients, one box of 8 coefficients x 2 limbs x 128 bytes; the A
  // tiles spread over the step
  auto load_box = [&](int s) {
    const uint32_t st = (uint32_t)(s % p.slots);
    const uint32_t dst = ring + st * p.box_bytes, full = full0 + 8 * st;
    wg::mbar_expect_tx(full, (uint32_t)(nkc * cts * pairs * 4 * 16 * BK));
    const int col = (s * g.D + m) * g.ncols + col0;
    for (int kc = 0; kc < nkc; ++kc)
      for (int ct = 0; ct < cts; ++ct)
        for (int h = 0; h < pairs; ++h) {
          for (int w = 0; w < 4; ++w)
            tma_load_3d(dst + ((kc * cts + ct) * 2 + h) * TILE_BYTES + w * 16 * BK, &kmap, full,
                        kc * BK, q0 + ct * CT + 8 * w, col + 2 * h);
          // a whole box-step from every SM at once queues the chain's own
          // L2 traffic behind it
          __nanosleep(p.pace_ns);
        }
  };

  if (threadIdx.x == 0) {
    for (int st = 0; st < p.slots; ++st) {
      wg::mbar_init(full0 + 8 * st, 1);          // the producer's expect_tx
      wg::mbar_init(empty0 + 8 * st, CONSUMERS);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (blockIdx.x == 0) *counter = 0u;
  }
  __syncthreads();  // the barriers exist before the producer's first copy
  if (warp == CONSUMERS && lane == 0)  // the first steps' keys, while the grid starts
    for (int s = 0; s < p.slots && s < g.n; ++s) load_box(s);

  // both accumulators start as the initial one; the partials as zero
  const int gtid = blockIdx.x * THREADS + threadIdx.x, gthreads = gridDim.x * THREADS;
  for (unsigned e = gtid; e < (unsigned)(B * CN); e += gthreads) {
    const int gate = (int)(e / (unsigned)CN);
    const uint32_t v = init_acc_word(acc_in, barb, gate, (int)e - gate * CN, N, C, g.mu);
    p0[e] = v;
    p1[e] = v;
  }
  uint32_t* prev = reinterpret_cast<uint32_t*>(base + p.prev_off);
  for (int e = threadIdx.x; e < items * nt * 32; e += THREADS) prev[e] = 0u;
  if (threadIdx.x < B) rot[threadIdx.x] = __ldg(bara + (size_t)threadIdx.x * g.n) & (2 * N - 1);
  grid.sync();

  if (warp == CONSUMERS) {
    // the producer: refill each slot once its consumers have released it
    if (lane == 0)
      for (int s = p.slots; s < g.n; ++s) {
        const uint32_t st = (uint32_t)(s % p.slots);
        wg::mbar_wait(empty0 + 8 * st, (uint32_t)((s / p.slots) & 1) ^ 1u);
        load_box(s);
      }
    return;
  }

  const uint32_t lmask = (1u << g.lb) - 1u, half = 1u << (g.lb - 1);
  // the warpgroup, shuffled so that ptxas sees it uniform: wgmmas on a path
  // it takes for divergent are serialised
  const int tid = threadIdx.x, quads = bs / 4, wgi = __shfl_sync(0xffffffffu, warp / 4, 0);
  // a limb past the polynomial's (the second of an odd pair: the next
  // column's bytes) is masked off
  uint32_t shift[MAX_LIMBS], keep[MAX_LIMBS];
#pragma unroll
  for (int lim = 0; lim < MAX_LIMBS; ++lim) {
    shift[lim] = lim < nl ? g.col_shift[col0 + lim] : 0;
    keep[lim] = lim < nl ? 0xFFFFFFFFu : 0u;
  }

  for (int s = 0; s < g.n; ++s) {
    const uint32_t* cur = s & 1 ? p1 : p0;
    uint32_t* next = s & 1 ? p0 : p1;
    // the digit rows of the block's pairs: row r = p * B + gate holds digit
    // block i0 + p, reduction byte k = (lev*C + c)*bs + q in chunk k / BK.
    // A lane takes quad q of one (row, c) and the next lane quad q + 4: the
    // rotated words t - a .. t - a + 3 lie in two aligned groups of four,
    // the lane's own and the next lane's (a shuffle), so a warp reads each
    // accumulator sector once. QPT quads a lane at once, all loads first.
    const int total = M * C * quads;
    for (int w0 = tid - lane; w0 < total; w0 += QPT * CONSUMERS * 32) {
      uint32_t x[QPT][4];
      int row[QPT], cq[QPT];
#pragma unroll
      for (int h = 0; h < QPT; ++h) {
        const int e = w0 + h * CONSUMERS * 32 + lane;
        const bool ok = e < total;
        const int r = ok ? e / (C * quads) : 0, rem = e - r * (C * quads);
        const int c = ok ? rem / quads : 0, q = ok ? (rem - c * quads) * 4 : 0;
        const int pp = r / B, gate = r - pp * B;
        const int t = (i0 + pp) * bs + q;
        const int a = rot[(s & 1) * MAX_B + gate];
        const uint32_t* w = cur + ((size_t)gate * C + c) * N;
        // the group of four at (t - a) rounded down, and the one after it;
        // a group below 0 wraps to the top, negated (N is a multiple of 4)
        const int src = t - (a & (N - 1)), lo_at = src & ~3, sh = src - lo_at;
        const bool flip = a >= N;
        uint4 own = make_uint4(0, 0, 0, 0), lo = own;
        if (ok) {
          own = __ldcg(reinterpret_cast<const uint4*>(w + t));
          lo = __ldcg(reinterpret_cast<const uint4*>(w + (lo_at < 0 ? lo_at + N : lo_at)));
          if ((lo_at < 0) != flip) lo = make_uint4(0u - lo.x, 0u - lo.y, 0u - lo.z, 0u - lo.w);
        }
        uint4 hi;
        hi.x = __shfl_down_sync(0xffffffffu, lo.x, 1);
        hi.y = __shfl_down_sync(0xffffffffu, lo.y, 1);
        hi.z = __shfl_down_sync(0xffffffffu, lo.z, 1);
        hi.w = __shfl_down_sync(0xffffffffu, lo.w, 1);
        // the next lane holds the next group unless it starts another run
        if (ok && (lane == 31 || q + 4 == bs || e + 1 >= total) && sh) {
          const int hi_at = lo_at + 4;
          hi = __ldcg(reinterpret_cast<const uint4*>(w + (hi_at < 0 ? hi_at + N : hi_at)));
          if ((hi_at < 0) != flip) hi = make_uint4(0u - hi.x, 0u - hi.y, 0u - hi.z, 0u - hi.w);
        }
        const uint32_t v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        const uint32_t o[4] = {own.x, own.y, own.z, own.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          // sh is 0..3: pick word sh + u of the eight without local memory
          uint32_t pick = v[u];
#pragma unroll
          for (int k = 1; k < 4; ++k)
            if (sh == k) pick = v[u + k];
          x[h][u] = pick - o[u] + g.offset;
        }
        row[h] = ok ? r : -1;
        cq[h] = c * bs + q;
      }
#pragma unroll
      for (int h = 0; h < QPT; ++h) {
        if (row[h] < 0) continue;
        for (int lev = 0; lev < g.l; ++lev) {
          const int sh = 32 - (lev + 1) * g.lb;
          uint32_t packed = 0;
#pragma unroll
          for (int u = 0; u < 4; ++u)
            packed |= (uint32_t)(uint8_t)gadget_digit(x[h][u], sh, lmask, half) << (8 * u);
          const int k = lev * C * bs + cq[h], kc = k / BK, kb = k - kc * BK;
          *reinterpret_cast<uint32_t*>(base + p.dig_off + kc * p.mtp * BK +
                                       tile_offset<BK>(row[h], kb >> 4) + (kb & 15)) = packed;
        }
      }
    }
    // wgmma reads the rows through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumer_sync();
    // the next step's rotations, read after the step barrier
    if (tid < B && s + 1 < g.n)
      rot[((s + 1) & 1) * MAX_B + tid] = __ldg(bara + (size_t)tid * g.n + s + 1) & (2 * N - 1);

    const uint32_t st = (uint32_t)(s % p.slots);
    wg::mbar_wait(full0 + 8 * st, (uint32_t)((s / p.slots) & 1));
    for (int item = wgi; item < items; item += 2) {
      const int ct = item % cts, tile = (item / cts) % ntiles, part = item / (cts * ntiles);
      Item it;
      it.key = ring + st * p.box_bytes + ct * 2 * TILE_BYTES;
      it.chunk_a = cts * 2 * TILE_BYTES;
      it.dig = ring + p.dig_off + tile * nt * BK;
      it.chunk_b = p.mtp * BK;
      it.part = part;
      it.kparts = kparts;
      it.nkc = nkc;
      it.n0 = tile * nt;
      it.M = M;
      it.B = B;
      it.next = next + (size_t)poly * N;
      it.i0 = i0;
      it.d = d;
      it.C = C;
      it.N = N;
      it.bs = bs;
      it.coef = q0 + ct * CT + 8 * ((tid & 127) >> 5) + ((tid & 31) >> 2);
      it.kept = prev + item * nt * 32 + (tid & 127);
      switch (nt) {
        case 8: run_item<8>(it, shift, keep); break;
        case 16: run_item<16>(it, shift, keep); break;
        default: run_item<32>(it, shift, keep); break;
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);  // this warp is done with the slot
    if (s + 1 < g.n) step_barrier(counter, gridDim.x * (unsigned)(s + 1));
  }
}

namespace lat {

// The launch: a 3-D tensor map of the key (n*D*ncols key columns x bs
// coefficients x R*bs bytes; boxes of 2 columns x 8 coefficients x 128
// bytes, 128-byte swizzle), the plan from `layout`, one cooperative launch
// of the step's key boxes, one block each (the runtime refuses a grid that
// is not co-resident). scratch is the second accumulator (B*C*N words) and
// the barrier counter after it.
static cudaError_t launch(uint32_t* out, const int32_t* acc_in, const int32_t* barb,
                          const int32_t* bara, const int8_t* key, int8_t* scratch, Geom g,
                          int blocks, const int* layout, int* grid_used, cudaStream_t stream) {
  Plan p;
  if (layout == nullptr || !make_plan(g, layout, p)) return cudaErrorInvalidValue;
  const int grid = (2 * g.nb - 1) * g.C * p.per_group;
  if (blocks != grid) return cudaErrorInvalidValue;
  wg::EncodeTiled encode = wg::encoder();
  if (encode == nullptr) return cudaErrorInvalidValue;
  CUtensorMap kmap;
  const cuuint64_t rbs = (cuuint64_t)g.R * g.bs;
  const cuuint64_t dim[3] = {rbs, (cuuint64_t)g.bs, (cuuint64_t)g.n * g.D * g.ncols};
  const cuuint64_t stride[2] = {rbs, rbs * g.bs};
  const cuuint32_t box[3] = {BK, 8, 2}, estride[3] = {1, 1, 1};
  if (encode(&kmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<int8_t*>(key), dim, stride, box,
             estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  auto kernel = blind_rotate_kernel_latency;
  // fails where the bytes exceed what a block may take
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute coop;
  coop.id = cudaLaunchAttributeCooperative;
  coop.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cfg.attrs = &coop;
  cfg.numAttrs = 1;
  if (grid_used != nullptr) *grid_used = grid;
  uint32_t* second = reinterpret_cast<uint32_t*>(scratch);
  unsigned* counter = reinterpret_cast<unsigned*>(scratch + (size_t)g.B * g.C * g.N * 4);
  return cudaLaunchKernelEx(&cfg, kernel, out, acc_in, barb, bara, second, counter, kmap, g, p);
}

}  // namespace lat
