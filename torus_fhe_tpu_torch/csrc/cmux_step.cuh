// Per-step pieces shared by the blind-rotate kernels: blind_rotate.cu (over
// the expanded F-block key) and blind_rotate_sel.cu (over the compact lines).
// Torus words are uint32_t: they wrap mod 2^32, where signed overflow would be
// undefined in C++.
#pragma once

#include <stdint.h>

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

// x = (X^a * p)[t] - p[t] + offset for one accumulator polynomial p of N
// words, a in [0, 2N): the rotation is read by index, negated past the wrap.
__device__ __forceinline__ uint32_t cmux_diff(const uint32_t* p, int t, int a, int N,
                                              uint32_t offset) {
  const int a1 = a & (N - 1);
  uint32_t r = t >= a1 ? p[t - a1] : 0u - p[t - a1 + N];
  if (a >= N) r = 0u - r;
  return r - p[t] + offset;
}

// Gadget digit of x at shift = 32 - (lev+1)*lb: ((x >> shift) & (Bg-1)) -
// Bg/2, in [-Bg/2, Bg/2) (lb <= 8, so it fits an int8). mask = Bg-1 and
// half = Bg/2 are computed once per kernel by the caller: computing them per
// call changed ptxas's schedule of blind_rotate.cu's key loads and made it
// 1.4x slower at one gate per block (measured on an H100).
__device__ __forceinline__ int8_t gadget_digit(uint32_t x, int shift, uint32_t mask,
                                               uint32_t half) {
  return (int8_t)(((x >> shift) & mask) - half);
}
