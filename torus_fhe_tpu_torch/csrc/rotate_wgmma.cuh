// The GEMM-phase tile of blind_rotate.cu for wide batches: warpgroup MMAs
// (wgmma) fed by a TMA ring, with the key box multicast to a 2-block cluster.
//
// What bounds the mma.sync tiles of rotate_gemm.cuh at B = 1024: each tile of
// 256 gates x 32 coefficients x 4 limbs reads its whole reduction (K = R*N
// bytes) for 256 digit rows and 128 key rows, 604 MB a step from L2 into the
// SMs at tfhe_128, and an SM issues an m16n8k32 about every 3 clocks where
// the tensor cores need 1. Both limits bind at once, so this tile removes
// both:
//   * A block computes 128 gates x 64 coefficients x 4 limbs: two consumer
//     warpgroups, each wgmma.m64n256k32 s8 x s8 -> s32 with both operands
//     K-major in shared memory. A is the digit rows (gate, k); B is the key
//     rows limb-major, one 64-row box a limb column col0 + limb of the kernel
//     layout (n, D, ncols*bs, R*bs) seen as rows of R*bs bytes, so a thread's
//     accumulator fragment holds all four limbs of its coefficients and the
//     epilogue adds without atomics, as the mma.sync tiles do.
//   * A ring of STAGES stages of 128 reduction bytes (16 KB of digits, 32 KB
//     of key), 128-byte swizzled, filled by TMA from one producer thread and
//     released through mbarrier full/empty pairs: no block-wide barrier a
//     stage. TMA fills digit rows past B with zeros.
//   * Two blocks of a cluster take two gate tiles of the same (j, poly, qt)
//     key box: each loads half the box's limbs and multicasts them to both,
//     so a pair of tiles draws 2 x 128 digit rows and 256 key rows, not 2 x
//     384 rows: 403 MB a step at tfhe_128 instead of 604.
// The block is 9 warps (two consumer warpgroups and the producer warp). At
// one block an SM, 224 registers a thread fit the register file without
// setmaxnreg, which would need a whole producer warpgroup and paths that
// never reconverge; here every warp joins the digit phase and the grid
// barriers of every step.
// Everything else is the frame of rotate_gemm.cuh: one cooperative launch a
// rotate (the cluster dimension is a launch attribute beside it), the digit
// phase and a grid barrier after each phase, accumulators and int8 digit rows
// in global memory (L2). The TMA reads digit rows that generic stores wrote,
// so writers and the producer each fence the async proxy around the barrier.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include "rotate_gemm.cuh"

namespace wg {

constexpr int BM = 128, WQ = 64, BK = 128, STAGES = 4;
constexpr int CLUSTER = 2;                        // gate tiles of one key box
constexpr int CONSUMERS = 2;                      // warpgroups of 64 gates
constexpr int THREADS = CONSUMERS * 128 + 32;     // and the producer warp
constexpr int A_BYTES = BM * BK;                  // digit rows of a stage
constexpr int LIMB_BYTES = WQ * BK;               // one limb's key box
constexpr int STAGE_BYTES = A_BYTES + MAX_LIMBS * LIMB_BYTES;
// the ring, 1024 bytes to align it for the 128-byte swizzle, the barriers
constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// arrive on the barrier at the same offset in block `rank` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n .reg .b32 ra;\n"
      " mapa.shared::cluster.u32 ra, %0, %1;\n"
      " mbarrier.arrive.release.cluster.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

// this block's rank in its cluster, the cluster's index, the clusters
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(v));
  return v;
}

__device__ __forceinline__ uint32_t cluster_index() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(v));
  return v;
}

__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(v));
  return v;
}

// the box of `map` at (c0 bytes, c1 rows) into this block's shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the same box into the same offset of every block in `mask`, each block's
// barrier at `bar` counting its bytes
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int c0, int c1,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c0), "r"(c1)
      : "memory");
}

// shared-memory matrix descriptor: K-major rows of 128 bytes, 128-byte
// swizzle, 8-row groups 1024 bytes apart (the start is 16-byte units)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}

// d += A (64 x 32 bytes at da) x B (256 x 32 bytes at db)^T, int8 -> int32.
// Thread t of the warpgroup holds rows 16*(t/32) + (t%32)/4 (+8) and columns
// 8*i + 2*(t%4) (+1): d[4i], d[4i+1] in the first row, d[4i+2], d[4i+3] in
// the second.
__device__ __forceinline__ void wgmma_256(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{ %0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110,"
      " %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124,"
      " %125, %126, %127},"
      " %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]),
        "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]),
        "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]),
        "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),
        "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]),
        "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]),
        "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]),
        "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]),
        "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]),
        "+r"(d[127])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

// One step's tiles of a cluster: pair tile pt is gate tiles 2*(pt % MP) and
// 2*(pt % MP) + 1 (the block of that rank) of key box pt / MP, dealt to the
// clusters round-robin; a pair's second tile past the last gate tile computes
// zeros and stores nothing.
struct Pairs {
  int MP, QT;  // gate tile pairs, column tiles in a block of bs coefficients
  __device__ void tile(int pt, uint32_t rank, int C, int& mt, int& j, int& poly,
                       int& qt) const {
    mt = CLUSTER * (pt % MP) + (int)rank;
    int nt = pt / MP;
    qt = nt % QT;
    nt /= QT;
    poly = nt % C;
    j = nt / C;
  }
};

}  // namespace wg

__global__ void __launch_bounds__(wg::THREADS, 1)
    blind_rotate_kernel_wgmma(uint32_t* acc, const int32_t* __restrict__ acc_in,
                              const int32_t* __restrict__ barb,
                              const int32_t* __restrict__ bara, int8_t* dig,
                              const __grid_constant__ CUtensorMap dmap,
                              const __grid_constant__ CUtensorMap kmap, Geom g) {
  using namespace wg;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int B = g.B, N = g.N, C = g.C, bs = g.bs;
  const int CN = C * N, Rbs = g.R * bs, K = g.nb * Rbs;
  const int nk_i = Rbs / BK, nk = g.nb * nk_i;
  const int gtid = blockIdx.x * THREADS + threadIdx.x, gthreads = gridDim.x * THREADS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint32_t rank = cluster_rank(), cid = cluster_index(), ncl = cluster_count();

  // the ring, 1024-byte aligned, then full[STAGES] and empty[STAGES]
  const uint32_t ring = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t full0 = ring + STAGES * STAGE_BYTES, empty0 = full0 + STAGES * 8;
  if (threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);                       // the producer's expect_tx
      mbar_init(empty0 + 8 * st, CONSUMERS * CLUSTER);    // every consumer of the pair
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  for (unsigned e = gtid; e < (unsigned)(B * CN); e += gthreads) {
    const int gate = (int)(e / (unsigned)CN);
    acc[e] = init_acc_word(acc_in, barb, gate, (int)e - gate * CN, N, C, g.mu);
  }
  grid.sync();

  const uint32_t lmask = (1u << g.lb) - 1u, half = 1u << (g.lb - 1);
  const int quads = CN / 4, nquad = N / 4;
  const int MT = (B + BM - 1) / BM;
  const Pairs pairs{(MT + CLUSTER - 1) / CLUSTER, bs / WQ};
  const int npairs = pairs.MP * g.nb * C * pairs.QT;
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

    if (warp == CONSUMERS * 4) {
      // the producer: one thread keeps the ring full
      if (lane == 0) {
        asm volatile("fence.proxy.async.global;\n" ::: "memory");
        for (int pt = cid; pt < npairs; pt += ncl) {
          int mt, j, poly, qt;
          pairs.tile(pt, rank, C, mt, j, poly, qt);
          const int nl = g.poly_nl[poly];
          // key row of limb 0 in block m = 0 of step s
          const int row0 = ((s * g.D) * g.ncols + g.poly_col[poly]) * bs + qt * WQ;
          for (int kc = 0; kc < nk; ++kc, ++it) {
            const uint32_t st = it % STAGES, ph = (it / STAGES) & 1;
            const uint32_t a_dst = ring + st * STAGE_BYTES, full = full0 + 8 * st;
            mbar_wait(empty0 + 8 * st, ph ^ 1);
            mbar_expect_tx(full, A_BYTES + nl * LIMB_BYTES);
            tma_load(a_dst, &dmap, full, kc * BK, mt * BM);
            const int i = kc / nk_i, kk = (kc - i * nk_i) * BK;
            const int m = i >= j ? i - j : i - j + g.D;
            const int row = row0 + m * g.ncols * bs;
            // this block's half of the limbs, to both blocks
#pragma unroll
            for (int h = 0; h < MAX_LIMBS / CLUSTER; ++h) {
              const int limb = (int)rank * (MAX_LIMBS / CLUSTER) + h;
              if (limb < nl)
                tma_load_multicast(a_dst + A_BYTES + limb * LIMB_BYTES, &kmap, full, kk,
                                   row + limb * bs, (uint16_t)((1u << CLUSTER) - 1));
            }
          }
        }
      }
      __syncwarp();
    } else {
      // a consumer warpgroup: 64 gates of the tile, all 256 key rows
      const int wgi = warp >> 2, tid = threadIdx.x & 127;
      // thread 32 * r releases a consumed stage to the producer of rank r
      const bool releases = (tid & 31) == 0 && tid < 32 * CLUSTER;
      const uint32_t peer = tid >> 5;
      for (int pt = cid; pt < npairs; pt += ncl) {
        int mt, j, poly, qt;
        pairs.tile(pt, rank, C, mt, j, poly, qt);
        int d[128];
#pragma unroll
        for (int r = 0; r < 128; ++r) d[r] = 0;
        uint32_t prev = 0;
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const uint32_t st = it % STAGES, ph = (it / STAGES) & 1;
          const uint32_t a_smem = ring + st * STAGE_BYTES;
          mbar_wait(full0 + 8 * st, ph);
          wgmma_fence();
          const uint64_t da = smem_desc(a_smem + wgi * (64 * BK));
          const uint64_t db = smem_desc(a_smem + A_BYTES);
#pragma unroll
          for (int ks = 0; ks < BK / 32; ++ks) wgmma_256(d, da + 2 * ks, db + 2 * ks);
          wgmma_commit();
          if (kc > 0) {
            // the previous stage's products are done: both blocks' producers
            // may refill it
            wgmma_wait<1>();
            if (releases) mbar_arrive_cluster(empty0 + 8 * prev, peer);
          }
          prev = st;
        }
        wgmma_wait<0>();
        if (releases) mbar_arrive_cluster(empty0 + 8 * prev, peer);

        // epilogue: rows r0 and r0 + 8, coefficients 8*qg + 2*(tid%4), +1,
        // every limb in registers
        const int nl = g.poly_nl[poly], col0 = g.poly_col[poly];
        uint32_t shift[MAX_LIMBS];
#pragma unroll
        for (int lim = 0; lim < MAX_LIMBS; ++lim)
          shift[lim] = lim < nl ? g.col_shift[col0 + lim] : 0;
        const int r0 = mt * BM + wgi * 64 + (tid >> 5) * 16 + ((tid & 31) >> 2);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int gate = r0 + 8 * h;
          if (gate >= B) continue;
          uint32_t* row = acc + ((size_t)gate * C + poly) * N + j * bs + qt * WQ + 2 * (tid & 3);
#pragma unroll
          for (int qg = 0; qg < WQ / 8; ++qg) {
            uint32_t v0 = 0, v1 = 0;
#pragma unroll
            for (int lim = 0; lim < MAX_LIMBS; ++lim)
              if (lim < nl) {
                v0 += (uint32_t)d[(lim * (WQ / 8) + qg) * 4 + 2 * h] << shift[lim];
                v1 += (uint32_t)d[(lim * (WQ / 8) + qg) * 4 + 2 * h + 1] << shift[lim];
              }
            uint2* dst = reinterpret_cast<uint2*>(row + 8 * qg);
            uint2 w = __ldcg(dst);
            w.x += v0;
            w.y += v1;
            *dst = w;
          }
        }
      }
    }
    grid.sync();
  }
  cluster_sync();  // no block leaves while its pair may still signal it
}

namespace wg {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime loaded: no link flag
static EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// a 2-D map of rows x row_bytes int8, boxes of box_rows x 128 bytes, 128-byte
// swizzle; rows past the end read as zeros
static bool encode(CUtensorMap* map, const void* base, uint64_t row_bytes, uint64_t rows,
                   uint32_t box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dim[2] = {row_bytes, rows}, stride[1] = {row_bytes};
  const cuuint32_t box[2] = {BK, box_rows}, estride[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dim, stride, box,
            estride, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The launch: the tensor maps of the digit rows (B x K) and of the key rows
// (n*D*ncols*bs x R*bs), the grid cut to whole clusters that are co-resident,
// one cooperative launch with a cluster dimension of CLUSTER.
static cudaError_t launch(uint32_t* acc, const int32_t* acc_in, const int32_t* barb,
                          const int32_t* bara, const int8_t* key, int8_t* dig, Geom g,
                          int blocks, int* grid_used, cudaStream_t stream) {
  if (g.bs % WQ || (g.R * g.bs) % BK) return cudaErrorInvalidValue;
  CUtensorMap dmap, kmap;
  const uint64_t rbs = (uint64_t)g.R * g.bs;
  if (!encode(&dmap, dig, g.nb * rbs, (uint64_t)g.B, BM) ||
      !encode(&kmap, key, rbs, (uint64_t)g.n * g.D * g.ncols * g.bs, WQ))
    return cudaErrorInvalidValue;
  auto kernel = blind_rotate_kernel_wgmma;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = CLUSTER;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(CLUSTER * ((blocks + CLUSTER - 1) / CLUSTER));
  int clusters = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg)) != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;
  // the grid barrier needs every block resident at once
  const int want = (blocks + CLUSTER - 1) / CLUSTER;
  const int grid = CLUSTER * (want < clusters ? want : clusters);
  if (grid_used != nullptr) *grid_used = grid;
  cfg.gridDim = dim3(grid);
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, kernel, acc, acc_in, barb, bara, dig, dmap, kmap, g);
}

}  // namespace wg
