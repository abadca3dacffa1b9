// host_native - the host-side native runtime of torus_fhe_tpu_torch.
//
// Exact integer jobs around the device path, on the host with OpenMP:
// keygen-scale negacyclic products (schoolbook, 64-bit wrapping sums, exact
// mod 2^bits) and Benaloh-Leichter threshold share generation. The same three
// functions, with the same C interface, as the JAX package's native runtime.
//
// Built at first use with g++ -O3 -fopenmp -fPIC -shared into
// torus_fhe_tpu_torch/_build/ and bound through ctypes
// (torus_fhe_tpu_torch/ops/native.py).

#include <cstdint>
#include <cstring>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// Exact negacyclic convolution: for each of `batch` pairs,
//   out[c] = sum_{i+j==c} a[i]*b[j] - sum_{i+j==c+N} a[i]*b[j]   (mod 2^64)
// a: (batch, N) int32 small operands (keys, digits, randomness)
// b: (batch, N) int64 torus operands
// out: (batch, N) int64 (callers truncate to the torus width)
static void negacyclic_one(const int32_t* a, const int64_t* b, int64_t* out,
                           int n) {
    // schoolbook with wraparound fold; O(N^2) but cache-friendly. The sums
    // are unsigned, whose wrap mod 2^64 is defined (a signed one is not).
    uint64_t* o = reinterpret_cast<uint64_t*>(out);
    for (int c = 0; c < n; ++c) o[c] = 0;
    for (int i = 0; i < n; ++i) {
        const uint64_t ai = static_cast<uint64_t>(static_cast<int64_t>(a[i]));
        if (ai == 0) continue;
        int j = 0;
        const int lim = n - i;
        for (; j < lim; ++j) o[i + j] += ai * static_cast<uint64_t>(b[j]);
        for (; j < n; ++j) o[i + j - n] -= ai * static_cast<uint64_t>(b[j]);
    }
}

void negacyclic_polymul_batch(const int32_t* a, const int64_t* b, int64_t* out,
                              int64_t batch, int32_t n) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t k = 0; k < batch; ++k) {
        negacyclic_one(a + k * n, b + k * n, out + k * n, n);
    }
}

// Benaloh–Leichter share generation, streaming form (shareSecret2,
// threshold_decryption_functions.cpp:287-336): given the secret key rows
// (k, N) and uniform random blocks (groups, t-1, k, N), emit shares
// (groups, t, k, N) where share[g, 0] = key + sum_j blocks[g, j] and
// share[g, i>0] = blocks[g, t-1-i].
void bl_shares_stream(const int32_t* key, const int32_t* blocks, int32_t* out,
                      int64_t groups, int32_t t, int32_t k, int32_t n) {
    const int64_t kn = (int64_t)k * n;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t g = 0; g < groups; ++g) {
        const int32_t* blk = blocks + g * (t - 1) * kn;
        int32_t* sh = out + g * (int64_t)t * kn;
        // party 0: key + sum of blocks
        for (int64_t x = 0; x < kn; ++x) {
            int64_t acc = key[x];
            for (int j = 0; j < t - 1; ++j) acc += blk[j * kn + x];
            sh[x] = (int32_t)acc;
        }
        // party i>0: block t-1-i
        for (int i = 1; i < t; ++i) {
            std::memcpy(sh + i * kn, blk + (int64_t)(t - 1 - i) * kn,
                        kn * sizeof(int32_t));
        }
    }
}

// Benaloh–Leichter share matmul S = M . rho over int32 (the cblas_dgemm of
// threshold_decryption_functions.cpp:194-222, in exact integer arithmetic).
// M: (d, e) int32 binary, rho: (e, n) int32, out: (d, n) int32.
void bl_share_matmul(const int32_t* M, const int32_t* rho, int32_t* out,
                     int64_t d, int64_t e, int64_t n) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t r = 0; r < d; ++r) {
        int64_t* acc = new int64_t[n]();
        const int32_t* mrow = M + r * e;
        for (int64_t j = 0; j < e; ++j) {
            if (mrow[j] == 0) continue;
            const int32_t mv = mrow[j];
            const int32_t* rr = rho + j * n;
            for (int64_t c = 0; c < n; ++c) acc[c] += (int64_t)mv * rr[c];
        }
        for (int64_t c = 0; c < n; ++c) out[r * n + c] = (int32_t)acc[c];
        delete[] acc;
    }
}

int32_t torus_native_version() { return 1; }

}  // extern "C"
