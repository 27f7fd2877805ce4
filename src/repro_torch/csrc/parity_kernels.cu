// ParM's coded hot-path kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (see repro_torch/kernels/_build.py).
//
// Every entry point takes device pointers and a cudaStream_t, launches on that
// stream without synchronising, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
// Element types: dtype code 0 = float32, 1 = bfloat16.  All arithmetic and
// every accumulation runs in fp32.  The coefficients of the encode and the
// two decodes arrive by value as launch parameters, copied from host memory
// by the C entry; those of the fused and projection kernels as fp32 device
// arrays.
//
// Kernels in this file:
//   encode_kernel         replaces repro/kernels/parity_encode.py:
//                         parity_encode
//   parity_decode_kernel  replaces repro/kernels/parity_decode.py:
//                         parity_decode
//   mg_decode_kernel      replaces repro/kernels/multigroup_decode.py:
//                         multigroup_decode
//   fused_cluster_kernel  replaces repro/kernels/fused_encode_forward.py:
//                         fused_encode_forward, split over F inside a
//                         thread-block cluster
//   project_kernel        replaces repro/kernels/learned_encoder.py:
//                         learned_project, and through it repro/kernels/
//                         berrut_encoder.py:berrut_encode (W = C^T)
//   empty_kernel          a measurement probe, not a port of anything
//
// Built with -DREPRO_CHECKED (kernels/_build.py: library(checked=True)),
// REPRO_CHECK(cond) prints the failed condition and traps; otherwise it is
// empty.  It guards the indices of fused_cluster_kernel, encode_kernel and
// mg_decode_kernel.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <atomic>
#include <type_traits>

#ifdef REPRO_CHECKED
#define REPRO_CHECK(cond)                                                   \
  do {                                                                      \
    if (!(cond)) {                                                          \
      printf("REPRO_CHECK failed: %s (%s:%d, block %d %d %d, thread %d)\n", \
             #cond, __FILE__, __LINE__, blockIdx.x, blockIdx.y, blockIdx.z, \
             threadIdx.x);                                                  \
      __trap();                                                             \
    }                                                                       \
  } while (0)
#else
#define REPRO_CHECK(cond) \
  do {                    \
  } while (0)
#endif

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;   // 16 resident blocks per SM

inline int blocks_for(int64_t n) {
  int64_t b = (n + kThreads - 1) / kThreads;
  return static_cast<int>(b < kMaxBlocks ? b : kMaxBlocks);
}

// 16 bytes of T: N values, unpacked to fp32 and packed back
template <typename T> struct Lanes;
template <> struct Lanes<float> {
  static constexpr int N = 4;
  using Bits = unsigned int;
  static __device__ __forceinline__ void unpack(const uint4& r,
                                                float (&x)[4]) {
    x[0] = __uint_as_float(r.x);
    x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z);
    x[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&x)[4]) {
    return make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                      __float_as_uint(x[2]), __float_as_uint(x[3]));
  }
};
template <> struct Lanes<__nv_bfloat16> {
  static constexpr int N = 8;
  using Bits = unsigned short;
  static __device__ __forceinline__ void unpack(const uint4& r,
                                                float (&x)[8]) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&x)[8]) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    return r;
  }
};

// Elements [e0, e0 + N) of a row as 16 bytes: one vector load, or (VEC =
// false) one load per element below n, zero past it
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_lanes(const T* row, int64_t e0,
                                            int64_t n) {
  using L = Lanes<T>;
  if constexpr (VEC) {
    return __ldcs(reinterpret_cast<const uint4*>(row + e0));
  } else {
    typename L::Bits b[L::N];
    const typename L::Bits* src =
        reinterpret_cast<const typename L::Bits*>(row);
#pragma unroll
    for (int k = 0; k < L::N; ++k)
      b[k] = e0 + k < n ? __ldcs(src + e0 + k) : 0;
    uint4 r;
    memcpy(&r, b, sizeof r);
    return r;
  }
}

// ---------------------------------------------------------------- encode ---
// P[j, e] = sum_i C[j, i] * X[i, e] over the flattened [B*F] element index
// e, for each of the r parity rows j: queries X [k, n], coefficients C
// [r, k] fp32, out [r, n] in X's dtype.  The reference encodes one row per
// call; this kernel writes all r rows in one launch.
//
// Bound on the H100: the launch.  The work is device-memory bytes (k reads
// and r writes per element, one multiply-add per member and row), but at the
// serving shapes (k=2, B<=4, F=784) a call moves a few tens of KB, a few ns
// at 3.35 TB/s, against ~0.9 us for an empty launch.  What a call adds to
// the launch is the memory round trips that follow it, so the design keeps
// them to one:
// - The r * k coefficients travel by value in the launch parameters
//   (EncodeCoeffs, as DecodeCoeffs does for the one-group decode below):
//   no device array, no op to build one and no copy to the card.  Every
//   lane reads the same word, which the constant cache broadcasts.
// - k is a template parameter for k = 2, 3, 4, so a thread issues the
//   loads of all k members before its first multiply-add: one round trip,
//   not k dependent ones.  The generic instance (K = 0, any k with r * k <=
//   kMaxEncodeCoeffs) loads each member where it adds it, once per row.
// - Each thread owns 16 bytes of every member row (4 fp32 or 8 bf16
//   values), loaded and stored as one vector where n is a multiple of the
//   width and both pointers are 16-byte aligned (then n_vec = n / N, else
//   0), and writes those elements of all r rows.  The scalar loop after it
//   takes what no vector covers, bounded by n.
// - The arithmetic is the reference's: acc = x_0 c_0, then acc += x_i c_i,
//   in fp32 registers.
constexpr int kMaxEncodeCoeffs = 256;     // r * k
struct EncodeCoeffs {
  float c[kMaxEncodeCoeffs];
};

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const T* __restrict__ q, T* __restrict__ out,
              const __grid_constant__ EncodeCoeffs cf, int k, int r,
              int64_t n, int64_t n_vec) {
  using L = Lanes<T>;
  constexpr int N = L::N;
  const int kk = K ? K : k;
  REPRO_CHECK(kk >= 1 && r >= 1 && r * kk <= kMaxEncodeCoeffs);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t0 =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int64_t v = t0; v < n_vec; v += stride) {
    const int64_t e0 = v * N;
    REPRO_CHECK(e0 + N <= n);
    const uint4* src = reinterpret_cast<const uint4*>(q + e0);
    const int64_t row = n / N;            // a member's stride in vectors
    if constexpr (K > 0) {
      uint4 raw[K];
#pragma unroll
      for (int i = 0; i < K; ++i) raw[i] = src[i * row];
      for (int j = 0; j < r; ++j) {
        float acc[N], x[N];
        L::unpack(raw[0], x);
#pragma unroll
        for (int l = 0; l < N; ++l) acc[l] = x[l] * cf.c[j * K];
#pragma unroll
        for (int i = 1; i < K; ++i) {
          L::unpack(raw[i], x);
#pragma unroll
          for (int l = 0; l < N; ++l)
            acc[l] = fmaf(x[l], cf.c[j * K + i], acc[l]);
        }
        *reinterpret_cast<uint4*>(out + j * n + e0) = L::pack(acc);
      }
    } else {
      for (int j = 0; j < r; ++j) {
        float acc[N], x[N];
        L::unpack(src[0], x);
#pragma unroll
        for (int l = 0; l < N; ++l) acc[l] = x[l] * cf.c[j * kk];
        for (int i = 1; i < kk; ++i) {
          L::unpack(src[i * row], x);
#pragma unroll
          for (int l = 0; l < N; ++l)
            acc[l] = fmaf(x[l], cf.c[j * kk + i], acc[l]);
        }
        *reinterpret_cast<uint4*>(out + j * n + e0) = L::pack(acc);
      }
    }
  }
  for (int64_t e = n_vec * N + t0; e < n; e += stride) {
    if constexpr (K > 0) {
      float x[K];
#pragma unroll
      for (int i = 0; i < K; ++i) x[i] = to_f32(q[i * n + e]);
      for (int j = 0; j < r; ++j) {
        float acc = x[0] * cf.c[j * K];
#pragma unroll
        for (int i = 1; i < K; ++i) acc = fmaf(x[i], cf.c[j * K + i], acc);
        out[j * n + e] = from_f32<T>(acc);
      }
    } else {
      for (int j = 0; j < r; ++j) {
        float acc = to_f32(q[e]) * cf.c[j * kk];
        for (int i = 1; i < kk; ++i)
          acc = fmaf(to_f32(q[i * n + e]), cf.c[j * kk + i], acc);
        out[j * n + e] = from_f32<T>(acc);
      }
    }
  }
}

template <typename T>
void launch_encode(const void* q, void* out, const EncodeCoeffs& cf, int k,
                   int r, int64_t n, cudaStream_t s) {
  constexpr int N = Lanes<T>::N;
  const bool vec = n % N == 0 && (reinterpret_cast<uintptr_t>(q) |
                                   reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const int64_t n_vec = vec ? n / N : 0;
  const int blocks = blocks_for(n_vec + (n - n_vec * N));
  const T* qt = static_cast<const T*>(q);
  T* ot = static_cast<T*>(out);
  if (k == 2)
    encode_kernel<T, 2><<<blocks, kThreads, 0, s>>>(qt, ot, cf, k, r, n,
                                                      n_vec);
  else if (k == 3)
    encode_kernel<T, 3><<<blocks, kThreads, 0, s>>>(qt, ot, cf, k, r, n,
                                                      n_vec);
  else if (k == 4)
    encode_kernel<T, 4><<<blocks, kThreads, 0, s>>>(qt, ot, cf, k, r, n,
                                                      n_vec);
  else
    encode_kernel<T, 0><<<blocks, kThreads, 0, s>>>(qt, ot, cf, k, r, n,
                                                      n_vec);
}

// ---------------------------------------------------------------- decode ---
// out[g, e] = (P[g, e] - sum_i R[g, i] * O[g, i, e]) * R[g, k] for the G
// groups of one launch: parity outputs P [G, n], member outputs O [G, k, n],
// out [G, n].  Group g's row R[g] holds its code coefficients with 0 at its
// missing index j and 1 / c_j appended, so "which member is missing" is
// data and one kernel serves every pattern.
//
// Bound on the H100: the launch.  The work is device-memory bytes (k + 1
// reads and one write per element): at the serving shapes (G <= 4, k = 2,
// B*V = 10) and on the A_d path (G = 1000) well under 1 MB, under 0.1 us at
// 3.35 TB/s, against ~0.9 us for an empty launch.  Design:
// - The coefficients travel by value in the launch parameters, computed
//   on the host, where the missing indices stay: a call is one launch, with
//   no copy to the card and no op to build anything.  Two parameter blocks,
//   one kernel instance each:
//   - MgShared (2 KB), coefficients shared by all groups (every scheme's
//     decode): c_0..c_{k-1} and 1/c_0..1/c_{k-1}, and sel[g], group g's
//     missing index j, one byte, for up to kMgGroups groups.  A warp loads
//     its table words, which do not depend on j, while it loads j, then
//     selects: R[g, i] = (i == j ? 0 : c_i), R[g, k] = 1/c_j.
//   - MgRows (32,512 bytes; CUDA 12.1 and later let an sm_70+ kernel take
//     up to 32,764 bytes of parameters), per-group coefficients: the
//     launch's own rows, group g's at g (k + 1), kMgRowFloats / (k + 1)
//     groups a launch (2,709 at k = 2).
//   A call with more groups than one launch takes is several launches
//   (kernels/multigroup_decode.py:chunks).
// - k is a template parameter for k = 2, 3, 4 (K = 0: any k), so a warp
//   issues all its loads (j, the coefficients, P and the k member rows)
//   before its first multiply-add, as encode_kernel does.  Earlier designs
//   with runtime-k loops took 1.62-1.84 us at the A_d shape, at or above
//   the device-memory coefficient array they replace (PERF.md, section 6).
// - A warp per group.  Lanes of one warp that read different constant
//   words are served one word after the other; here all 32 read the same
//   word, one broadcast, and walk the group's n elements 32 at a time
//   (gridDim.x splits a long row over blocks).  The index is (group,
//   element), with no division.
// - Every member is read, the missing one too: a NaN or Inf in its
//   placeholder output reaches the result through its 0 coefficient, as in
//   the reference.
constexpr int kMgWarps = 8;             // groups per block
constexpr int kMgTableFloats = 256;     // 2k shared words
constexpr int kMgGroups = 1024;         // groups per launch, shared
constexpr int kMgRowFloats = 8128;      // per-group rows of k + 1
struct MgShared {
  static constexpr bool kRows = false;
  float table[kMgTableFloats];
  uint8_t sel[kMgGroups];
};
struct MgRows {
  static constexpr bool kRows = true;
  float rows[kMgRowFloats];
};

// Group g's coefficient R[g, i] for i < k, and R[g, k] = 1 / c_j
__device__ __forceinline__ float mg_coeff(const MgShared& cf, int g, int k,
                                          int i) {
  return i == cf.sel[g] ? 0.f : cf.table[i];
}
__device__ __forceinline__ float mg_coeff(const MgRows& cf, int g, int k,
                                          int i) {
  return cf.rows[g * (k + 1) + i];
}
__device__ __forceinline__ float mg_inv(const MgShared& cf, int g, int k) {
  // every 1/c_i is loaded beside j and one kept: no load waits on j
  const int j = cf.sel[g];
  float inv = 0.f;
#pragma unroll 4
  for (int i = 0; i < k; ++i) inv = i == j ? cf.table[k + i] : inv;
  return inv;
}
__device__ __forceinline__ float mg_inv(const MgRows& cf, int g, int k) {
  return cf.rows[g * (k + 1) + k];
}

template <typename T, int K, typename Cf>
__global__ void __launch_bounds__(kMgWarps * 32)
mg_decode_kernel(const T* __restrict__ p, const T* __restrict__ o,
                 T* __restrict__ out, const __grid_constant__ Cf cf, int G,
                 int k, int64_t n) {
  const int g = blockIdx.y * (blockDim.x / 32) + threadIdx.x / 32;
  if (g >= G) return;
  const int kk = K ? K : k;
  if constexpr (Cf::kRows)
    REPRO_CHECK(kk >= 1 && (g + 1) * (kk + 1) <= kMgRowFloats);
  else
    REPRO_CHECK(kk >= 1 && 2 * kk <= kMgTableFloats && g < kMgGroups &&
                cf.sel[g] < kk);
  const T* pg = p + g * n;
  const T* og = o + static_cast<int64_t>(g) * kk * n;
  T* outg = out + g * n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * 32;
  const int64_t x0 = static_cast<int64_t>(blockIdx.x) * 32 + threadIdx.x % 32;
  const float inv = mg_inv(cf, g, kk);
  if constexpr (K > 0) {
    float c[K];
#pragma unroll
    for (int i = 0; i < K; ++i) c[i] = mg_coeff(cf, g, K, i);
    for (int64_t x = x0; x < n; x += stride) {
      float v[K];
#pragma unroll
      for (int i = 0; i < K; ++i) v[i] = to_f32(og[i * n + x]);
      float acc = to_f32(pg[x]);
#pragma unroll
      for (int i = 0; i < K; ++i) acc -= v[i] * c[i];
      outg[x] = from_f32<T>(acc * inv);
    }
  } else {
    for (int64_t x = x0; x < n; x += stride) {
      float acc = to_f32(pg[x]);
#pragma unroll 4
      for (int i = 0; i < k; ++i)
        acc -= to_f32(og[i * n + x]) * mg_coeff(cf, g, k, i);
      outg[x] = from_f32<T>(acc * inv);
    }
  }
}

template <typename T, typename Cf>
void launch_mg_decode(const void* p, const void* o, const Cf& cf, void* out,
                      int G, int k, int64_t n, cudaStream_t s) {
  const int warps = G < kMgWarps ? G : kMgWarps;
  const int64_t gy = (G + warps - 1) / warps;
  const int64_t cap = kMaxBlocks * kMgWarps / gy;
  int64_t gx = (n + 31) / 32;
  if (gx > cap) gx = cap > 0 ? cap : 1;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  const T* pt = static_cast<const T*>(p);
  const T* ot = static_cast<const T*>(o);
  T* dst = static_cast<T*>(out);
  if (k == 2)
    mg_decode_kernel<T, 2, Cf><<<grid, warps * 32, 0, s>>>(pt, ot, dst, cf,
                                                            G, k, n);
  else if (k == 3)
    mg_decode_kernel<T, 3, Cf><<<grid, warps * 32, 0, s>>>(pt, ot, dst, cf,
                                                            G, k, n);
  else if (k == 4)
    mg_decode_kernel<T, 4, Cf><<<grid, warps * 32, 0, s>>>(pt, ot, dst, cf,
                                                            G, k, n);
  else
    mg_decode_kernel<T, 0, Cf><<<grid, warps * 32, 0, s>>>(pt, ot, dst, cf,
                                                            G, k, n);
}

template <typename Cf>
int launch_mg_dtype(const void* p, const void* o, const Cf& cf, void* out,
                    int G, int k, int64_t n, int dtype, cudaStream_t s) {
  if (dtype == 0)
    launch_mg_decode<float>(p, o, cf, out, G, k, n, s);
  else if (dtype == 1)
    launch_mg_decode<__nv_bfloat16>(p, o, cf, out, G, k, n, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------ one-group decode ---
// out[e] = (P[e] - sum_i c[i] * O[i, e]) * c[k], the G = 1 case of the
// decode above, with c = (avail_0 .. avail_{k-1}, 1 / c_missing) passed by
// value.
//
// Bound on the H100: the launch.  The serving shape ([2, 1, 10]) moves
// 160 bytes, a few ns at 3.35 TB/s, against a device time of ~1.5 us, so
// what a call costs is the host's launch work.  The coefficients are
// computed on the host (the scheme keeps them there) and copied into the
// kernel's parameter space, so the call issues one launch and nothing else:
// no device op builds them, and no copy moves them to the card.
// Design: one thread per element, grid-stride; every thread reads the same
// few coefficient words from parameter space.
constexpr int kMaxDecodeK = 32;
struct DecodeCoeffs {
  float c[kMaxDecodeK + 1];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
parity_decode_kernel(const T* __restrict__ p, const T* __restrict__ o,
                     T* __restrict__ out, const DecodeCoeffs cf, int k,
                     int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       e < n; e += stride) {
    float acc = to_f32(p[e]);
    for (int i = 0; i < k; ++i) acc -= to_f32(o[i * n + e]) * cf.c[i];
    out[e] = from_f32<T>(acc * cf.c[k]);
  }
}

// ---------------------------------------------------------------- fused ----
// out[j, b, v] = sum_f (sum_i C[j, i] * X[i, b, f]) * W[j, f, v]
// queries X [k, B, F], coeffs C [r, k] fp32, weights W [r, F, V], out
// [r, B, V] in X's dtype.  Replaces repro/kernels/fused_encode_forward.py:
// fused_encode_forward (B2).
//
// Bound on the H100: operations.  On the A_d path ([2,1000,784] x
// [1,784,200] fp32) it is 0.31 GFLOP against ~7.7 MB of traffic, and fp32
// stays IEEE fp32 (the reference tolerance rules out TF32 tensor cores), so
// the ceiling is the 67 TFLOP/s SIMT rate: 4.7 us.  Two things keep a SIMT
// GEMM of this size from it: too few warps per SM (a grid of output tiles
// alone is about one block per SM), and, per contraction step, loads and
// the encode that stall every warp between its FMA runs.
// Design: one launch, a split-F thread-block cluster per output tile, and
// producer warps that feed four FMA warps.
// - Tiles of kFBM x kFBN outputs of parity row j; the S CTAs of a cluster
//   (S = 1..8, along x) each walk their own slice of F: steps [rank * n /
//   S, (rank + 1) * n / S) of the n = ceil(F / kFBK) steps (fused_slices in
//   kernels/fused_encode_forward.py is the same arithmetic).  S is the
//   largest cluster size whose clusters all fit on the card at once
//   (cudaOccupancyMaxActiveClusters, read once per instance, device and k;
//   fused_plan mirrors the rule): as many warps as one wave holds, and no
//   second wave.  At the A_d shape: 64 tiles, S = 5 on an H100 (it holds
//   69 clusters of 5), 320 CTAs of 8 warps, 5 steps each.
// - Warps 4-7 produce.  Thread 128 asks TMA for each step's boxes, the k
//   query tiles [k][kFBM][kFBK] and the W tile [kFBK][kFBN] in their own
//   dtypes, rows of 128 bytes in fp32 (TMA's rate falls with narrower
//   rows), into a ring of two stages; TMA zero-fills past B, V and F, so
//   both operands are 0 there (0 * junk is not 0 when the junk is NaN).
//   Once a stage lands (its mbarrier's transaction count), the four warps
//   encode it, sum_i C[j, i] X_i in fp32, into an fp32 [kFBM][kFBK + 4]
//   tile (bf16 W is widened beside it), so the encoded [r, B, F] queries
//   never reach device memory, and arrive on the stage's "encoded"
//   mbarrier.  A stage is refilled when the FMA warps have released it.
//   Where a row is not 16-byte aligned (F or V not a whole vector, a
//   pointer off 16 bytes) or F = 0, the TMA = false instance loads the same
//   boxes element by element, never outside [0, F), [0, B) or [0, V).
// - Warps 0-3 only multiply: each thread keeps a 4 x 8 fp32 register tile
//   (fused_row / fused_col); per four steps of depth it reads four float4s
//   of the encoded tile and eight of W for 128 FMAs, waits on nothing but
//   the stage's mbarrier, and releases the stage with one arrive per warp.
//   No __syncthreads in the loop.
// - The partial tiles sum through distributed shared memory: once every
//   CTA of the cluster has left its loop (a cluster barrier), thread row ty
//   (4 output rows) belongs to CTA ty / ceil(16 / S), and every CTA stores
//   its partial of those rows straight into the owner's shared memory, in
//   the slot of its rank (the ring is free by then, and holds the slots).
//   One cluster barrier later each owner sums the S slots in rank order (a
//   fixed order: the result is deterministic) and writes its rows.  No
//   atomics, no scratch tensor, no second launch.
// - fp32 is fmaf throughout; bf16 inputs are widened and accumulated in
//   fp32.  An mbarrier wait that never completes traps after ~2 s.  k is
//   at most 8 (two fp32 stages of 8 query tiles fill the shared memory).  A
//   bf16 wgmma route is later work.
constexpr int kFBM = 64;                   // batch rows of an output tile
constexpr int kFBN = 64;                   // output columns of a tile
constexpr int kFBK = 32;                   // contraction depth of a stage
constexpr int kFTM = 4;                    // rows per thread
constexpr int kFTN = 8;                    // columns per thread
constexpr int kFMaxStages = 2;
constexpr int kFMinBlocks = 3;             // resident CTAs the registers allow
constexpr int kFRowsT = kFBM / kFTM;       // 16 thread rows
constexpr int kFColsT = kFBN / kFTN;       // 8 thread columns
constexpr int kFProducerWarps = 4;
constexpr int kFConsumers = kFRowsT * kFColsT;   // 128 FMA threads
constexpr int kFWarps = kFConsumers / 32;        // the first producer warp
constexpr int kFProducers = 32 * kFProducerWarps;
constexpr int kFThreads = kFConsumers + kFProducers;
constexpr int kFMaxCluster = 8;            // the portable cluster size
constexpr int kFMaxK = 8;                  // queries per group (ring size)
constexpr int kFEncLd = kFBK + 4;          // padded: conflict-free reads
constexpr int kFMaxSmem = 231424;      // the opt-in 227 KB less 1 KB static
constexpr long long kFHangCycles = 4000000000LL;  // ~2 s: a wait traps
static_assert(kFTN % 4 == 0 && kFBK % 4 == 0,
              "fragments are read as float4s");
static_assert(kFConsumers % 32 == 0, "whole FMA warps");

__host__ __device__ inline int fused_per(int S) {
  return (kFRowsT + S - 1) / S;            // thread rows each owner takes
}

// A thread's fragment: row i of its kFTM rows, kFRowsT rows apart (a
// warp's four thread rows are consecutive, so its float4 reads of the
// encoded tile cover distinct banks), and column t of its kFTN columns, in
// groups of four kFBN / (kFTN / 4) columns apart
__host__ __device__ constexpr int fused_row(int i, int ty) {
  return i * kFRowsT + ty;
}
__host__ __device__ constexpr int fused_col(int t, int tx) {
  return t / 4 * 4 * kFColsT + tx * 4 + t % 4;
}

__host__ __device__ constexpr int fused_align(int bytes) {
  return (bytes + 127) / 128 * 128;
}

// Shared-memory layout (bytes) of one launch: a ring of `nst` stages (raw
// queries, raw W, the encoded tile, bf16 W widened), the cluster's receive
// slots aliasing the ring, then 3 kFMaxStages mbarriers.  128 bytes more
// than `total` are allocated, to align the base for TMA.
struct FusedLayout {
  int xs, ws, es, stage, nst, recv, region, total;
  __host__ __device__ FusedLayout(int k, int S, int sx, int sw) {
    xs = fused_align(k * kFBM * kFBK * sx);
    ws = fused_align(kFBK * kFBN * sw);
    es = fused_align(kFBM * kFEncLd * 4);
    stage = xs + ws + es + (sw == 4 ? 0 : kFBK * kFBN * 4);
    const int room = kFMaxSmem - 128 - 3 * kFMaxStages * 8;
    nst = room / stage < kFMaxStages ? room / stage : kFMaxStages;
    recv = S > 1 ? S * fused_per(S) * kFTM * kFBN * 4 : 0;
    region = nst * stage > recv ? nst * stage : recv;
    total = region + 3 * kFMaxStages * 8;
  }
};

// The cluster size for `tiles` output tiles, given `capacity[S]`, the
// clusters of S CTAs the card holds at once (S = 1..kFMaxCluster): the
// largest S whose clusters all fit in one wave, else 1.  kernels/
// fused_encode_forward.py:fused_plan is the same rule.
int fused_cluster_size(long long tiles, const int* capacity) {
  for (int S = kFMaxCluster; S > 1; --S)
    if (capacity[S] >= tiles) return S;
  return 1;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > kFHangCycles) {
      __trap();
    }
  }
}

// One TMA box of a 3-D map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Split arrive / wait on the cluster barrier (all threads of every CTA)
__device__ __forceinline__ void cluster_arrive() {   // release
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {     // acquire
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Four consecutive elements of shared memory as fp32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Named barrier 1 over the producer warps only
__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(kFProducers) : "memory");
}

// What the producer warps need to fill a stage
template <typename TX, typename TW>
struct FusedSrc {
  const CUtensorMap* xmap;
  const CUtensorMap* wmap;
  const TX* x;
  const TW* wj;
  int k, B, F, V, b0, v0, j, f_end;
  int64_t x_n, w_n, w_off;                 // for the checked build
};

// Step `s` (F columns from f0) into `stage`: TMA boxes completing on
// `full`, or (TMA = false) the warp's element loads, zero outside [0, B),
// [0, V) and [f0, f_end)
template <typename TX, typename TW, bool TMA>
__device__ __forceinline__ void fused_fill(uint8_t* stage, const FusedLayout& L,
                                           const FusedSrc<TX, TW>& a, int f0,
                                           uint64_t* full, int pt) {
  if constexpr (TMA) {
    if (pt == 0) {
      mbar_expect_tx(full, a.k * kFBM * kFBK * sizeof(TX) +
                               kFBK * kFBN * sizeof(TW));
      tma_load3(stage, a.xmap, full, f0, a.b0, 0);
      tma_load3(stage + L.xs, a.wmap, full, a.v0, f0, a.j);
    }
  } else {
    TX* xs = reinterpret_cast<TX*>(stage);
    TW* ws = reinterpret_cast<TW*>(stage + L.xs);
    for (int e = pt; e < a.k * kFBM * kFBK; e += kFProducers) {
      const int i = e / (kFBM * kFBK), b = e / kFBK % kFBM,
                f = f0 + e % kFBK;
      const int64_t src = (static_cast<int64_t>(i) * a.B + a.b0 + b) * a.F + f;
      const bool ok = a.b0 + b < a.B && f < a.f_end;
      REPRO_CHECK(!ok || (src >= 0 && src < a.x_n));
      xs[e] = ok ? a.x[src] : from_f32<TX>(0.f);
    }
    for (int e = pt; e < kFBK * kFBN; e += kFProducers) {
      const int f = f0 + e / kFBN, v = a.v0 + e % kFBN;
      const int64_t src = static_cast<int64_t>(f) * a.V + v;
      const bool ok = f < a.f_end && v < a.V;
      REPRO_CHECK(!ok || (src >= 0 && a.w_off + src < a.w_n));
      ws[e] = ok ? a.wj[src] : from_f32<TW>(0.f);
    }
    producer_sync();
  }
}

// (the element-wise instance keeps more registers: its loads spill at the
// TMA instance's bound)
template <typename TX, typename TW, bool TMA>
__global__ void __launch_bounds__(kFThreads, TMA ? kFMinBlocks : 2)
fused_cluster_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const TX* __restrict__ x, const float* __restrict__ C,
                     const TW* __restrict__ w, TX* __restrict__ out, int k,
                     int B, int F, int V, int S) {
  namespace cg = cooperative_groups;
  extern __shared__ __align__(128) uint8_t fsm_raw[];
  __shared__ float cs[kFMaxK];             // C[j, :]
  uint8_t* fsm = fsm_raw + ((128u - (smem_u32(fsm_raw) & 127u)) & 127u);
  const FusedLayout L(k, S, sizeof(TX), sizeof(TW));
  uint64_t* full = reinterpret_cast<uint64_t*>(fsm + L.region);
  uint64_t* encd = full + kFMaxStages;
  uint64_t* empty = encd + kFMaxStages;
  float* recv = reinterpret_cast<float*>(fsm);    // aliases the ring
  constexpr bool kWideW = !std::is_same<TW, float>::value;

  const int rank = blockIdx.x % S;
  const int v0 = blockIdx.x / S * kFBN, b0 = blockIdx.y * kFBM;
  const int j = blockIdx.z, r = gridDim.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this CTA's slice of the F steps (fused_slices in the wrapper)
  const int steps = (F + kFBK - 1) / kFBK;
  const int sb = static_cast<int>(static_cast<int64_t>(rank) * steps / S);
  const int se =
      static_cast<int>(static_cast<int64_t>(rank + 1) * steps / S);
  const int n = se - sb;
  const int nst = L.nst;
  if (tid == 0) {
    for (int s = 0; s < kFMaxStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&encd[s], kFProducerWarps);
      mbar_init(&empty[s], kFWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < k) {
    REPRO_CHECK(j < r);
    cs[tid] = C[static_cast<int64_t>(j) * k + tid];
  }
  __syncthreads();

  float acc[kFTM][kFTN];
#pragma unroll
  for (int i = 0; i < kFTM; ++i)
#pragma unroll
    for (int t = 0; t < kFTN; ++t) acc[i][t] = 0.f;
  const int tx = tid % kFColsT, ty = tid / kFColsT;   // FMA threads

  if (warp >= kFWarps) {
    // producers: fill, encode, refill what the FMA warps released
    const int pt = tid - kFConsumers;
    const int64_t w_off = static_cast<int64_t>(j) * F * V;
    const FusedSrc<TX, TW> a{&xmap, &wmap, x, w + w_off, k, B, F, V, b0, v0,
                             j, min(se * kFBK, F),
                             static_cast<int64_t>(k) * B * F,
                             static_cast<int64_t>(r) * F * V, w_off};
    for (int s = 0; s < n && s < nst; ++s)
      fused_fill<TX, TW, TMA>(fsm + s * L.stage, L, a, (sb + s) * kFBK,
                              &full[s], pt);
    for (int s = 0; s < n; ++s) {
      const int q = s % nst;
      uint8_t* st = fsm + q * L.stage;
      if constexpr (TMA) mbar_wait(&full[q], (s / nst) & 1);
      const TX* xs = reinterpret_cast<const TX*>(st);
      float* enc = reinterpret_cast<float*>(st + L.xs + L.ws);
      for (int e4 = pt; e4 < kFBM * kFBK / 4; e4 += kFProducers) {
        float4 e = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int i = 0; i < k; ++i) {
          REPRO_CHECK(i * kFBM * kFBK + 4 * e4 + 4 <= k * kFBM * kFBK);
          const float4 v = load4(xs + i * kFBM * kFBK + 4 * e4);
          const float c = cs[i];
          e.x = fmaf(v.x, c, e.x);
          e.y = fmaf(v.y, c, e.y);
          e.z = fmaf(v.z, c, e.z);
          e.w = fmaf(v.w, c, e.w);
        }
        REPRO_CHECK(e4 / (kFBK / 4) * kFEncLd + e4 % (kFBK / 4) * 4 + 4 <=
                    kFBM * kFEncLd);
        *reinterpret_cast<float4*>(enc + e4 / (kFBK / 4) * kFEncLd +
                                   e4 % (kFBK / 4) * 4) = e;
      }
      if constexpr (kWideW) {
        const TW* ws = reinterpret_cast<const TW*>(st + L.xs);
        for (int e4 = pt; e4 < kFBK * kFBN / 4; e4 += kFProducers) {
          REPRO_CHECK(4 * e4 + 4 <= kFBK * kFBN);
          reinterpret_cast<float4*>(st + L.xs + L.ws + L.es)[e4] =
              load4(ws + 4 * e4);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&encd[q]);
      // refill the stage of step s - 1 once the FMA warps released it
      const int p = s - 1;
      if (p >= 0 && p + nst < n && (!TMA || pt == 0)) {
        mbar_wait(&empty[p % nst], (p / nst) & 1);
        fused_fill<TX, TW, TMA>(fsm + (p % nst) * L.stage, L, a,
                                (sb + p + nst) * kFBK, &full[p % nst], pt);
      }
    }
  } else {
    // FMA warps: 8 x 4 outputs per thread, four steps of depth at a time
    for (int s = 0; s < n; ++s) {
      const int q = s % nst;
      const uint8_t* st = fsm + q * L.stage;
      mbar_wait(&encd[q], (s / nst) & 1);
      const float* enc = reinterpret_cast<const float*>(st + L.xs + L.ws);
      const float* wt = reinterpret_cast<const float*>(
          kWideW ? st + L.xs + L.ws + L.es : st + L.xs);
#pragma unroll
      for (int kq = 0; kq < kFBK; kq += 4) {
        float a[kFTM][4];
#pragma unroll
        for (int i = 0; i < kFTM; ++i) {
          REPRO_CHECK(fused_row(i, ty) * kFEncLd + kq + 4 <= kFBM * kFEncLd);
          const float4 v = load4(enc + fused_row(i, ty) * kFEncLd + kq);
          a[i][0] = v.x, a[i][1] = v.y, a[i][2] = v.z, a[i][3] = v.w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float bv[kFTN];
#pragma unroll
          for (int t = 0; t < kFTN; t += 4) {
            REPRO_CHECK((kq + u) * kFBN + fused_col(t, tx) + 4 <=
                        kFBK * kFBN);
            const float4 v = load4(wt + (kq + u) * kFBN + fused_col(t, tx));
            bv[t] = v.x, bv[t + 1] = v.y, bv[t + 2] = v.z, bv[t + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < kFTM; ++i)
#pragma unroll
            for (int t = 0; t < kFTN; ++t)
              acc[i][t] = fmaf(a[i][u], bv[t], acc[i][t]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[q]);
    }
  }

  const bool producer = warp >= kFWarps;
  if (S > 1) {
    // every CTA has left its loop, so every ring is free: push this CTA's
    // partial of thread row ty into its owner's slot `rank`, then sum the
    // S slots of the rows this CTA owns
    cg::cluster_group cluster = cg::this_cluster();
    REPRO_CHECK(static_cast<int>(cluster.num_blocks()) == S &&
                static_cast<int>(cluster.block_rank()) == rank);
    const int per = fused_per(S);
    const int owner = ty / per, slot = ty - owner * per;
    cluster_arrive();
    cluster_wait();
    if (!producer) {
      REPRO_CHECK(owner < S && slot < per);
      float* dst = cluster.map_shared_rank(recv, owner);
#pragma unroll
      for (int i = 0; i < kFTM; ++i)
#pragma unroll
        for (int t = 0; t < kFTN; t += 4) {
          const int o = ((rank * per + slot) * kFTM + i) * kFBN +
                        fused_col(t, tx);
          REPRO_CHECK(o + 4 <= L.recv / 4);
          *reinterpret_cast<float4*>(dst + o) = make_float4(
              acc[i][t], acc[i][t + 1], acc[i][t + 2], acc[i][t + 3]);
        }
    }
    cluster_arrive();                      // every partial landed
    cluster_wait();
    if (producer || owner != rank) return;
#pragma unroll
    for (int i = 0; i < kFTM; ++i)
#pragma unroll
      for (int t = 0; t < kFTN; t += 4) {
        float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int c = 0; c < S; ++c) {
          const int o = ((c * per + slot) * kFTM + i) * kFBN +
                        fused_col(t, tx);
          REPRO_CHECK(o + 4 <= L.recv / 4);
          const float4 p = load4(recv + o);
          s4.x += p.x;
          s4.y += p.y;
          s4.z += p.z;
          s4.w += p.w;
        }
        acc[i][t] = s4.x, acc[i][t + 1] = s4.y;
        acc[i][t + 2] = s4.z, acc[i][t + 3] = s4.w;
      }
  } else if (producer) {
    return;
  }

  [[maybe_unused]] const int64_t out_n = static_cast<int64_t>(r) * B * V;
#pragma unroll
  for (int i = 0; i < kFTM; ++i) {
    const int b = b0 + fused_row(i, ty);
    if (b >= B) continue;
#pragma unroll
    for (int t = 0; t < kFTN; t += 4) {
      const int v = v0 + fused_col(t, tx);
      const int64_t o = (static_cast<int64_t>(j) * B + b) * V + v;
      if (TMA && v + 4 <= V) {             // V % 4 == 0, out 16-byte aligned
        REPRO_CHECK(o >= 0 && o + 4 <= out_n);
        if constexpr (std::is_same<TX, float>::value) {
          *reinterpret_cast<float4*>(out + o) = make_float4(
              acc[i][t], acc[i][t + 1], acc[i][t + 2], acc[i][t + 3]);
        } else {
          __nv_bfloat162 h[2] = {
              __floats2bfloat162_rn(acc[i][t], acc[i][t + 1]),
              __floats2bfloat162_rn(acc[i][t + 2], acc[i][t + 3])};
          *reinterpret_cast<uint2*>(out + o) = *reinterpret_cast<uint2*>(h);
        }
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (v + u < V) {
            REPRO_CHECK(o + u >= 0 && o + u < out_n);
            out[o + u] = from_f32<TX>(acc[i][t + u]);
          }
        }
      }
    }
  }
}

constexpr int kMaxDevices = 64;

// Dynamic shared memory up to kFMaxSmem for one instance, set once per
// device
template <typename TX, typename TW, bool TMA>
cudaError_t fused_prepare() {
  static std::atomic<int> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && ready[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(fused_cluster_kernel<TX, TW, TMA>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kFMaxSmem);
  if (err == cudaSuccess && dev < kMaxDevices)
    ready[dev].store(1, std::memory_order_release);
  return err;
}

// Output tiles (= clusters) of an [r, B, V] output
long long fused_tiles(int r, int B, int V) {
  return static_cast<long long>(r) * ((B + kFBM - 1) / kFBM) *
         ((V + kFBN - 1) / kFBN);
}

// The launch configuration of an (S * V tiles, B tiles, r) grid, clusters of
// S along x
struct FusedConfig {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  FusedConfig(int k, int S, int B, int V, int r, int sx, int sw,
              cudaStream_t st) {
    cfg.gridDim = dim3(S * ((V + kFBN - 1) / kFBN), (B + kFBM - 1) / kFBM, r);
    cfg.blockDim = dim3(kFThreads);
    cfg.dynamicSmemBytes = FusedLayout(k, S, sx, sw).total + 128;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = S;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// capacity[S], S = 1..kFMaxCluster: the clusters of S CTAs of one instance
// at k queries that the current device holds at once
// (cudaOccupancyMaxActiveClusters), read once per (device, k)
template <typename TX, typename TW, bool TMA>
cudaError_t fused_capacity(int k, int* capacity) {
  static std::atomic<int> cached[kMaxDevices][kFMaxK + 1][kFMaxCluster + 1];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  capacity[0] = 0;
  for (int S = 1; S <= kFMaxCluster; ++S) {
    int n = dev < kMaxDevices ? cached[dev][k][S].load() : 0;
    if (n == 0) {
      if (FusedLayout(k, S, sizeof(TX), sizeof(TW)).nst < 2)
        return cudaErrorInvalidValue;
      err = fused_prepare<TX, TW, TMA>();
      if (err != cudaSuccess) return err;
      FusedConfig fc(k, S, 1, 1, 1, sizeof(TX), sizeof(TW), nullptr);
      err = cudaOccupancyMaxActiveClusters(
          &n, fused_cluster_kernel<TX, TW, TMA>, &fc.cfg);
      if (err != cudaSuccess) return err;
      if (dev < kMaxDevices) cached[dev][k][S].store(n > 0 ? n : -1);
    }
    capacity[S] = n > 0 ? n : 0;
  }
  return cudaSuccess;
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime's
// entry-point query (no link against libcuda)
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// Negative return codes of the entry points: the tensor-map encode failed
constexpr int kErrNoEncode = -1;        // no cuTensorMapEncodeTiled
constexpr int kErrEncode = -1000;       // minus the CUresult of the encode

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over a contiguous [d2, d1, d0] tensor (d0 innermost) of `esize`
// bytes per element, boxes of (b0, b1, b2); reads past an edge give zeros
CUresult encode_map3(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                     int esize, int d0, int d1, int d2, int b0, int b1,
                     int b2) {
  const cuuint64_t dim[3] = {static_cast<cuuint64_t>(d0),
                             static_cast<cuuint64_t>(d1),
                             static_cast<cuuint64_t>(d2)};
  const cuuint64_t stride[2] = {dim[0] * esize, dim[0] * dim[1] * esize};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0),
                             static_cast<cuuint32_t>(b1),
                             static_cast<cuuint32_t>(b2)};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map,
             esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             3, const_cast<void*>(ptr), dim, stride, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <typename TX, typename TW, bool TMA>
int launch_fused_inst(const void* x, const void* C, const void* w, void* out,
                      int k, int r, int B, int F, int V, cudaStream_t s) {
  CUtensorMap xmap, wmap;
  memset(&xmap, 0, sizeof xmap);
  memset(&wmap, 0, sizeof wmap);
  if (TMA) {
    const EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return kErrNoEncode;
    CUresult res = encode_map3(enc, &xmap, x, sizeof(TX), F, B, k, kFBK,
                               kFBM, k);
    if (res == CUDA_SUCCESS)
      res = encode_map3(enc, &wmap, w, sizeof(TW), V, F, r, kFBN, kFBK, 1);
    if (res != CUDA_SUCCESS) return kErrEncode - static_cast<int>(res);
  }
  cudaError_t err = fused_prepare<TX, TW, TMA>();
  if (err != cudaSuccess) return static_cast<int>(err);
  int capacity[kFMaxCluster + 1];
  err = fused_capacity<TX, TW, TMA>(k, capacity);
  if (err != cudaSuccess) return static_cast<int>(err);
  int S = fused_cluster_size(fused_tiles(r, B, V), capacity);
  FusedConfig fc(k, S, B, V, r, sizeof(TX), sizeof(TW), s);
  const TX* xp = static_cast<const TX*>(x);
  const float* cp = static_cast<const float*>(C);
  const TW* wp = static_cast<const TW*>(w);
  TX* op = static_cast<TX*>(out);
  void* args[] = {&xmap, &wmap, &xp, &cp, &wp, &op, &k, &B, &F, &V, &S};
  err = cudaLaunchKernelExC(
      &fc.cfg, reinterpret_cast<const void*>(fused_cluster_kernel<TX, TW, TMA>),
      args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The TMA instance where every row of X, W and out starts 16-byte aligned
// (TMA's stride rule) and there is something to load
template <typename TX, typename TW>
int launch_fused(const void* x, const void* C, const void* w, void* out,
                 int k, int r, int B, int F, int V, cudaStream_t s) {
  const bool tma = F > 0 &&
                   static_cast<int64_t>(F) * sizeof(TX) % 16 == 0 &&
                   static_cast<int64_t>(V) * sizeof(TW) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(w) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  if (tma)
    return launch_fused_inst<TX, TW, true>(x, C, w, out, k, r, B, F, V, s);
  return launch_fused_inst<TX, TW, false>(x, C, w, out, k, r, B, F, V, s);
}

// ------------------------------------------------------- learned project ---
// out[j, e] = sum_h W[h, j] * H[h, e] over the flattened [B*F] element index
// e, for every output row j (H [H, n], W [H, r] fp32, out [r, n]).
//
// Bound on the H100: device-memory bytes.  Each element is read once per
// input row and written once per output row, with one multiply-add per
// (h, j) pair, so at the main-path shapes (H = 16 hidden units or k = 2
// queries, r <= 2) the kernel does well under one FLOP per byte moved: at
// the learned shape [16, 200, 3072] fp32 the bound is 41.8 MB, 12.5 us.
// Design: a stream at the HBM rate.
// - Each thread owns 16 bytes of every input row (4 fp32 or 8 bf16 values)
//   and issues its loads of up to LOADS rows before its first multiply-add
//   (in chunks of LOADS rows above that), with streaming hints (__ldcs /
//   __stcs: every byte is touched once).  LOADS is 16 (256 bytes in flight
//   per thread), or 4 for H <= 4 (the approxifer's k queries), whose fewer
//   registers let a grid of one vector per thread fit on the SMs at once.
// - Up to kProjRows output rows accumulate in fp32 registers (ROWS is 1, 2,
//   4 or 8, so a small r spends no registers on rows it lacks); larger r
//   puts further row groups on gridDim.y.  W's columns of the row group sit
//   in shared memory, where all threads read the same word.
// - The grid is what the SMs hold at once (the occupancy calculator's
//   blocks per SM times the SMs): one wave, each thread striding over the
//   vectors that remain.
// - Where n is not a multiple of the vector width or a pointer is not
//   16-byte aligned (rows then start unaligned), the VEC = false instance
//   loads and stores the same 16-byte share element by element, bounded by
//   n: nothing outside [0, n) is touched.
constexpr int kProjRows = 8;     // output rows per row group
constexpr int kProjLoads = 16;   // input rows loaded before the first FMA
constexpr int kProjFewLoads = 4; // the same for H <= 4: fewer registers

template <typename T, int ROWS, int LOADS, bool VEC>
__global__ void __launch_bounds__(kThreads)
project_kernel(const T* __restrict__ h, const float* __restrict__ w,
               T* __restrict__ out, int H, int r, int64_t n) {
  using L = Lanes<T>;
  constexpr int N = L::N;
  extern __shared__ float ws[];             // [H, ROWS] of this row group
  const int j0 = blockIdx.y * kProjRows;
  const int rows = min(ROWS, r - j0);
  for (int t = threadIdx.x; t < H * rows; t += blockDim.x)
    ws[(t / rows) * ROWS + t % rows] = w[(t / rows) * r + j0 + t % rows];
  __syncthreads();
  const int64_t n_vec = (n + N - 1) / N;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       v < n_vec; v += stride) {
    const int64_t e0 = v * N;
    float acc[ROWS][N];
#pragma unroll
    for (int j = 0; j < ROWS; ++j)
#pragma unroll
      for (int k = 0; k < N; ++k) acc[j][k] = 0.f;
    for (int i0 = 0; i0 < H; i0 += LOADS) {
      const int hc = min(LOADS, H - i0);
      uint4 raw[LOADS];
#pragma unroll
      for (int i = 0; i < LOADS; ++i)
        if (i < hc) raw[i] = load_lanes<T, VEC>(h + (i0 + i) * n, e0, n);
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        if (i < hc) {
          float x[N];
          L::unpack(raw[i], x);
          const float* wi = ws + (i0 + i) * ROWS;
#pragma unroll
          for (int j = 0; j < ROWS; ++j)
#pragma unroll
            for (int k = 0; k < N; ++k)
              acc[j][k] = fmaf(x[k], wi[j], acc[j][k]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      if (j >= rows) continue;
      T* o = out + (j0 + j) * n;
      if constexpr (VEC) {
        __stcs(reinterpret_cast<uint4*>(o + e0), L::pack(acc[j]));
      } else {
#pragma unroll
        for (int k = 0; k < N; ++k)
          if (e0 + k < n) o[e0 + k] = from_f32<T>(acc[j][k]);
      }
    }
  }
}

// Blocks of one project_kernel instance that the device's SMs hold at once
// (queried once per instance)
template <typename T, int ROWS, int LOADS, bool VEC>
int project_grid() {
  static const int blocks = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, project_kernel<T, ROWS, LOADS, VEC>, kThreads,
        sizeof(float) * LOADS * ROWS);
    return sms * per_sm > 0 ? sms * per_sm : 1;
  }();
  return blocks;
}

template <typename T, int ROWS, int LOADS, bool VEC>
void launch_project_rows(const void* h, const void* w, void* out, int H,
                         int r, int64_t n, cudaStream_t s) {
  const int64_t n_vec = (n + Lanes<T>::N - 1) / Lanes<T>::N;
  const int64_t need = (n_vec + kThreads - 1) / kThreads;
  const int cap = project_grid<T, ROWS, LOADS, VEC>();
  dim3 grid(static_cast<unsigned>(need < cap ? need : cap),
            (r + kProjRows - 1) / kProjRows);
  const size_t smem = sizeof(float) * H * ROWS;
  project_kernel<T, ROWS, LOADS, VEC><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(h), static_cast<const float*>(w),
      static_cast<T*>(out), H, r, n);
}

template <typename T, int ROWS>
void launch_project_vec(const void* h, const void* w, void* out, int H, int r,
                        int64_t n, cudaStream_t s) {
  const bool vec = n % Lanes<T>::N == 0 &&
                   (reinterpret_cast<uintptr_t>(h) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const bool few = H <= kProjFewLoads;
  if (vec && few)
    launch_project_rows<T, ROWS, kProjFewLoads, true>(h, w, out, H, r, n, s);
  else if (vec)
    launch_project_rows<T, ROWS, kProjLoads, true>(h, w, out, H, r, n, s);
  else if (few)
    launch_project_rows<T, ROWS, kProjFewLoads, false>(h, w, out, H, r, n,
                                                        s);
  else
    launch_project_rows<T, ROWS, kProjLoads, false>(h, w, out, H, r, n, s);
}

template <typename T>
void launch_project(const void* h, const void* w, void* out, int H, int r,
                    int64_t n, cudaStream_t s) {
  if (r == 1)
    launch_project_vec<T, 1>(h, w, out, H, r, n, s);
  else if (r == 2)
    launch_project_vec<T, 2>(h, w, out, H, r, n, s);
  else if (r <= 4)
    launch_project_vec<T, 4>(h, w, out, H, r, n, s);
  else
    launch_project_vec<T, kProjRows>(h, w, out, H, r, n, s);
}

// the launch probe of repro_empty_launch
__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// cudaErrorInvalidValue for a dtype code the kernels do not take
static int bad_dtype() { return static_cast<int>(cudaErrorInvalidValue); }

// queries [k, n]; coeffs: r * k floats in HOST memory, row-major [r, k],
// k >= 1, r >= 1 and r * k <= 256; out [r, n].  One launch of
// encode_kernel.
int repro_parity_encode(const void* q, const float* coeffs, void* out, int k,
                        int r, long long n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || r < 1 || static_cast<long long>(r) * k > kMaxEncodeCoeffs)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  EncodeCoeffs cf;
  memcpy(cf.c, coeffs, sizeof(float) * r * k);
  if (dtype == 0)
    launch_encode<float>(q, out, cf, k, r, n, s);
  else if (dtype == 1)
    launch_encode<__nv_bfloat16>(q, out, cf, k, r, n, s);
  else
    return bad_dtype();
  return static_cast<int>(cudaGetLastError());
}

// parity_out [n]; outputs [k, n]; coeffs: k + 1 floats in HOST memory
// (avail_0 .. avail_{k-1}, 1 / c_missing), 1 <= k <= 32; out [n]
int repro_parity_decode(const void* p, const void* o, const float* coeffs,
                        void* out, int k, long long n, int dtype,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kMaxDecodeK) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  DecodeCoeffs cf;
  for (int i = 0; i <= k; ++i) cf.c[i] = coeffs[i];
  if (dtype == 0) {
    parity_decode_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const float*>(p), static_cast<const float*>(o),
        static_cast<float*>(out), cf, k, n);
  } else if (dtype == 1) {
    parity_decode_kernel<__nv_bfloat16><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(p),
        static_cast<const __nv_bfloat16*>(o),
        static_cast<__nv_bfloat16*>(out), cf, k, n);
  } else {
    return bad_dtype();
  }
  return static_cast<int>(cudaGetLastError());
}

// parity_outs [G, n]; outputs [G, k, n]; out [G, n]; table and sel in HOST
// memory.  Shared coefficients (per_group = 0): table c_0..c_{k-1} then
// 1/c_0..1/c_{k-1} (2k <= 256), sel the G missing indices (each < k),
// G <= 1024.  Per-group (per_group = 1): table the G rows of k + 1
// (G (k + 1) <= 8128), sel unused.  One launch of mg_decode_kernel.
int repro_multigroup_decode(const void* p, const void* o, const float* table,
                            const uint8_t* sel, void* out, int G, int k,
                            long long n, int per_group, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || G < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (per_group) {
    if (static_cast<long long>(G) * (k + 1) > kMgRowFloats)
      return static_cast<int>(cudaErrorInvalidValue);
    if (G == 0 || n <= 0) return static_cast<int>(cudaGetLastError());
    MgRows cf;
    memcpy(cf.rows, table, sizeof(float) * G * (k + 1));
    return launch_mg_dtype(p, o, cf, out, G, k, n, dtype, s);
  }
  if (G > kMgGroups || 2LL * k > kMgTableFloats)
    return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  MgShared cf;
  memcpy(cf.table, table, sizeof(float) * 2 * k);
  for (int g = 0; g < G; ++g) {
    if (sel[g] >= k) return static_cast<int>(cudaErrorInvalidValue);
    cf.sel[g] = sel[g];
  }
  return launch_mg_dtype(p, o, cf, out, G, k, n, dtype, s);
}

// queries [k, B, F] (dtype_x), 1 <= k <= 8; coeffs [r, k] fp32; weights
// [r, F, V] (dtype_w); out [r, B, V] in dtype_x.  One launch of
// fused_cluster_kernel, clusters of fused_cluster_size CTAs.
int repro_fused_encode_forward(const void* x, const void* C, const void* w,
                               void* out, int k, int r, int B, int F, int V,
                               int dtype_x, int dtype_w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > kFMaxK || F < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (r <= 0 || B <= 0 || V <= 0) return static_cast<int>(cudaGetLastError());
  if (dtype_x == 0 && dtype_w == 0)
    return launch_fused<float, float>(x, C, w, out, k, r, B, F, V, s);
  if (dtype_x == 0 && dtype_w == 1)
    return launch_fused<float, __nv_bfloat16>(x, C, w, out, k, r, B, F, V,
                                              s);
  if (dtype_x == 1 && dtype_w == 0)
    return launch_fused<__nv_bfloat16, float>(x, C, w, out, k, r, B, F, V,
                                              s);
  if (dtype_x == 1 && dtype_w == 1)
    return launch_fused<__nv_bfloat16, __nv_bfloat16>(x, C, w, out, k, r, B,
                                                      F, V, s);
  return bad_dtype();
}

// capacity[0..8]: capacity[S] clusters of S CTAs of B2's (dtype_x,
// dtype_w, tma) instance at k queries the current device holds at once;
// *size: the cluster size B2 launches an [r, B, V] output with
// (kernels/fused_encode_forward.py:fused_plan must agree)
int repro_fused_plan(int k, int r, int B, int V, int dtype_x, int dtype_w,
                     int tma, int* capacity, int* size) {
  if (k < 1 || k > kFMaxK) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
#define REPRO_FUSED_CAPACITY(TX, TW)                                       \
  err = tma ? fused_capacity<TX, TW, true>(k, capacity)                    \
            : fused_capacity<TX, TW, false>(k, capacity)
  if (dtype_x == 0 && dtype_w == 0) REPRO_FUSED_CAPACITY(float, float);
  if (dtype_x == 0 && dtype_w == 1) REPRO_FUSED_CAPACITY(float, __nv_bfloat16);
  if (dtype_x == 1 && dtype_w == 0) REPRO_FUSED_CAPACITY(__nv_bfloat16, float);
  if (dtype_x == 1 && dtype_w == 1)
    REPRO_FUSED_CAPACITY(__nv_bfloat16, __nv_bfloat16);
#undef REPRO_FUSED_CAPACITY
  if (err == cudaSuccess)
    *size = fused_cluster_size(fused_tiles(r, B, V), capacity);
  return static_cast<int>(err);
}

// h [H, n] (dtype); w [H, r] fp32, H * 8 <= 12288 where r > 4 (H * 4 where
// r is 3 or 4, H * r below: 48 KB of shared memory); out [r, n] in h's
// dtype
int repro_learned_project(const void* h, const void* w, void* out, int H,
                          int r, long long n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || r <= 0) return static_cast<int>(cudaGetLastError());
  if (dtype == 0) {
    launch_project<float>(h, w, out, H, r, n, s);
  } else if (dtype == 1) {
    launch_project<__nv_bfloat16>(h, w, out, H, r, n, s);
  } else {
    return bad_dtype();
  }
  return static_cast<int>(cudaGetLastError());
}

// A measurement probe, not a kernel of the port: one empty launch through
// the same ctypes path as the kernels, so a measurement can state what a
// launch alone costs on the device
int repro_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// A cudaError_t, or a negative code for a failed driver call: -1 when the
// driver has no cuTensorMapEncodeTiled, -1000 - r when it returned CUresult r
const char* repro_error_string(int code) {
  static thread_local char buf[96];
  if (code == -1) return "cuTensorMapEncodeTiled not found in the driver";
  if (code <= -1000) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)",
             -1000 - code);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
