// ParM's coded hot-path kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (see repro_torch/kernels/_build.py).
//
// Every entry point takes device pointers and a cudaStream_t, launches on that
// stream without synchronising, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
// Element types: dtype code 0 = float32, 1 = bfloat16.  All arithmetic and
// every accumulation runs in fp32; coefficients arrive as fp32 device arrays,
// except parity_decode's, which arrive by value as launch parameters.
//
// Kernels in this file:
//   encode_kernel         replaces repro/kernels/parity_encode.py:
//                         parity_encode
//   parity_decode_kernel  replaces repro/kernels/parity_decode.py:
//                         parity_decode
//   mg_decode_kernel      replaces repro/kernels/multigroup_decode.py:
//                         multigroup_decode
//   fused_kernel          replaces repro/kernels/fused_encode_forward.py:
//                         fused_encode_forward
//   project_kernel        replaces repro/kernels/learned_encoder.py:
//                         learned_project, and through it repro/kernels/
//                         berrut_encoder.py:berrut_encode (W = C^T)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

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

// ---------------------------------------------------------------- encode ---
// P[e] = sum_i c[i] * X[i, e] over the flattened [B*F] element index e.
//
// Bound on the H100: device-memory bytes (k reads and one write per element,
// one multiply-add per read).  At the serving shapes (k=2, B<=4, F=784) the
// whole call moves a few tens of KB, so the launch latency is the bound.
// Design: one thread per output element in a grid-stride loop; neighbouring
// threads read neighbouring addresses of each of the k rows, so every warp
// load is coalesced; the k-loop runs in registers and the ragged tail is the
// loop bound, so no element outside [0, n) is touched.
template <typename T>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const T* __restrict__ q, const float* __restrict__ c,
              T* __restrict__ out, int k, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       e < n; e += stride) {
    float acc = to_f32(q[e]) * c[0];
    for (int i = 1; i < k; ++i) acc += to_f32(q[i * n + e]) * c[i];
    out[e] = from_f32<T>(acc);
  }
}

// ---------------------------------------------------------------- decode ---
// out[g, e] = (P[g, e] - sum_i cmat[g, i] * O[g, i, e]) * cmat[g, k]
// cmat[g] holds the code coefficients with a 0 at the missing index and
// 1/c_missing appended, so the "which member is missing" choice is data and
// one kernel serves every missing pattern (the single-group decode, whose
// coefficients live on the host, is parity_decode_kernel below).
//
// Bound on the H100: device-memory bytes (k+1 reads and one write per
// element).  At the serving shapes (G<=4, k=2, B<=4, V=10) and on the A_d path
// (G=1000, V=10) the call moves well under 1 MB, so launch latency bounds it.
// Design: one thread per output element over the flattened [G * B*V] index,
// grid-stride; the group's k+1 coefficients are read through the read-only
// cache (every thread of a group reads the same few words).
template <typename T>
__global__ void __launch_bounds__(kThreads)
mg_decode_kernel(const T* __restrict__ p, const T* __restrict__ o,
                 const float* __restrict__ cmat, T* __restrict__ out, int k,
                 int64_t n, int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       e < total; e += stride) {
    const int64_t g = e / n;
    const int64_t x = e - g * n;
    const float* cg = cmat + g * (k + 1);
    const T* og = o + g * k * n + x;
    float acc = to_f32(p[e]);
    for (int i = 0; i < k; ++i) acc -= to_f32(og[i * n]) * __ldg(cg + i);
    out[e] = from_f32<T>(acc * __ldg(cg + k));
  }
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
// Design: as mg_decode_kernel, one thread per element, grid-stride; every
// thread reads the same few coefficient words from parameter space.
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
//
// Bound on the H100: operations.  On the A_d path ([2,1000,784] x
// [1,784,200]) it is 0.31 GFLOP against ~7.7 MB of traffic, and fp32 must
// stay IEEE fp32 (the reference tolerance rules out TF32 tensor cores), so
// the ceiling is the 67 TFLOP/s SIMT fp32 rate, about 5 us.
// Design: a tiled SIMT GEMM with the encode folded into the A-operand load.
// One block owns a [FBM x FBN] output tile of parity row j (blockIdx.z) and
// walks F in FBK-deep steps: it combines the k query tiles with C[j, :] into
// an fp32 encoded tile in shared memory (the [r, B, F] encoded queries never
// reach device memory), stages the W[j] tile next to it, and each thread
// accumulates a 4x4 register tile with FMAs.  At the A_d shape the grid is
// only about one block per SM, so the kernel is bound by load latency rather
// than by the FMA rate: the global loads of step s+1 go to registers and
// are issued before the FMAs of step s, and all loads of one coding row
// issue together, so few load latencies are exposed per step.  Out-of-range
// rows of B, columns of V and the ragged F tail are zero-filled in BOTH
// tiles (0 * junk is not 0 when the junk is NaN), and stores are masked at
// the B and V edges.  Loads walk the contiguous dimension across a warp's
// lanes (coalesced), the encoded tile is padded one column against bank
// conflicts, and W rows are read as float4.  No tensor cores, no TMA: a
// bf16 wgmma path is later work.
constexpr int FBM = 32;   // batch rows per block
constexpr int FBN = 64;   // output columns per block
constexpr int FBK = 32;   // contraction depth per step
constexpr int FTM = 4;    // rows per thread
constexpr int FTN = 4;    // columns per thread
constexpr int FTHREADS = (FBM / FTM) * (FBN / FTN);   // 128
constexpr int ENC_PER_T = FBK * FBM / FTHREADS;       // 8
constexpr int W_PER_T = FBK * FBN / FTHREADS;         // 16
static_assert(FTN == 4, "W rows are read as one float4 per thread");
static_assert(ENC_PER_T * FTHREADS == FBK * FBM &&
                  W_PER_T * FTHREADS == FBK * FBN,
              "tiles split evenly over the block's threads");

// Global loads of one F step into registers: the W[j] tile, then the
// encoded A tile (k query rows combined with C[j, :]), zero outside the
// ranges.  The coding row index i is the outer loop, so each row's loads are
// independent and issue back to back instead of one latency per element.
template <typename TX, typename TW>
__device__ __forceinline__ void fused_load(
    const TX* __restrict__ x, const float* __restrict__ cj,
    const TW* __restrict__ wj, int k, int B, int F, int V, int b0, int v0,
    int f0, int tid, float (&enc_r)[ENC_PER_T], float (&w_r)[W_PER_T]) {
#pragma unroll
  for (int u = 0; u < W_PER_T; ++u) {
    const int e = tid + u * FTHREADS;
    const int f = f0 + e / FBN;
    const int v = v0 + e % FBN;
    w_r[u] = (f < F && v < V) ? to_f32(wj[static_cast<int64_t>(f) * V + v])
                              : 0.f;
  }
  for (int i = 0; i < k; ++i) {
    const TX* xi = x + static_cast<int64_t>(i) * B * F;
    const float ci = cj[i];
    float raw[ENC_PER_T];
#pragma unroll
    for (int u = 0; u < ENC_PER_T; ++u) {
      const int e = tid + u * FTHREADS;
      const int b = b0 + e / FBK;
      const int f = f0 + e % FBK;
      raw[u] = (b < B && f < F)
                   ? to_f32(xi[static_cast<int64_t>(b) * F + f])
                   : 0.f;
    }
#pragma unroll
    for (int u = 0; u < ENC_PER_T; ++u)
      enc_r[u] = i == 0 ? raw[u] * ci : enc_r[u] + raw[u] * ci;
  }
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(FTHREADS)
fused_kernel(const TX* __restrict__ x, const float* __restrict__ C,
             const TW* __restrict__ w, TX* __restrict__ out, int k, int B,
             int F, int V) {
  __shared__ float enc_s[FBK][FBM + 1];
  __shared__ __align__(16) float w_s[FBK][FBN];
  const int j = blockIdx.z;
  const int b0 = blockIdx.y * FBM;
  const int v0 = blockIdx.x * FBN;
  const int tid = threadIdx.x;
  const int tx = tid % (FBN / FTN);
  const int ty = tid / (FBN / FTN);
  const float* cj = C + static_cast<int64_t>(j) * k;
  const TW* wj = w + static_cast<int64_t>(j) * F * V;

  float acc[FTM][FTN];
#pragma unroll
  for (int i = 0; i < FTM; ++i)
#pragma unroll
    for (int t = 0; t < FTN; ++t) acc[i][t] = 0.f;

  float enc_r[ENC_PER_T], w_r[W_PER_T];
  fused_load(x, cj, wj, k, B, F, V, b0, v0, 0, tid, enc_r, w_r);
  for (int f0 = 0; f0 < F; f0 += FBK) {
#pragma unroll
    for (int u = 0; u < ENC_PER_T; ++u) {
      const int e = tid + u * FTHREADS;
      enc_s[e % FBK][e / FBK] = enc_r[u];
    }
#pragma unroll
    for (int u = 0; u < W_PER_T; ++u) {
      const int e = tid + u * FTHREADS;
      w_s[e / FBN][e % FBN] = w_r[u];
    }
    __syncthreads();
    if (f0 + FBK < F)     // next step's loads fly while this step computes
      fused_load(x, cj, wj, k, B, F, V, b0, v0, f0 + FBK, tid, enc_r, w_r);
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      float a[FTM];
#pragma unroll
      for (int i = 0; i < FTM; ++i) a[i] = enc_s[kk][ty * FTM + i];
      const float4 bv = *reinterpret_cast<const float4*>(&w_s[kk][tx * FTN]);
#pragma unroll
      for (int i = 0; i < FTM; ++i) {
        acc[i][0] = fmaf(a[i], bv.x, acc[i][0]);
        acc[i][1] = fmaf(a[i], bv.y, acc[i][1]);
        acc[i][2] = fmaf(a[i], bv.z, acc[i][2]);
        acc[i][3] = fmaf(a[i], bv.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < FTM; ++i) {
    const int b = b0 + ty * FTM + i;
    if (b >= B) continue;
#pragma unroll
    for (int t = 0; t < FTN; ++t) {
      const int v = v0 + tx * FTN + t;
      if (v < V)
        out[(static_cast<int64_t>(j) * B + b) * V + v] =
            from_f32<TX>(acc[i][t]);
    }
  }
}

template <typename TX, typename TW>
void launch_fused(const void* x, const void* C, const void* w, void* out,
                  int k, int r, int B, int F, int V, cudaStream_t s) {
  dim3 grid((V + FBN - 1) / FBN, (B + FBM - 1) / FBM, r);
  fused_kernel<TX, TW><<<grid, FTHREADS, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const float*>(C),
      static_cast<const TW*>(w), static_cast<TX*>(out), k, B, F, V);
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

}  // namespace

extern "C" {

// cudaErrorInvalidValue for a dtype code the kernels do not take
static int bad_dtype() { return static_cast<int>(cudaErrorInvalidValue); }

int repro_parity_encode(const void* q, const void* c, void* out, int k,
                        long long n, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  if (dtype == 0) {
    encode_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(c),
        static_cast<float*>(out), k, n);
  } else if (dtype == 1) {
    encode_kernel<__nv_bfloat16><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(c),
        static_cast<__nv_bfloat16*>(out), k, n);
  } else {
    return bad_dtype();
  }
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

// parity_outs [G, n]; outputs [G, k, n]; cmat [G, k+1] fp32; out [G, n]
int repro_multigroup_decode(const void* p, const void* o, const void* cmat,
                            void* out, int G, int k, long long n, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = static_cast<long long>(G) * n;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  if (dtype == 0) {
    mg_decode_kernel<float><<<blocks_for(total), kThreads, 0, s>>>(
        static_cast<const float*>(p), static_cast<const float*>(o),
        static_cast<const float*>(cmat), static_cast<float*>(out), k, n,
        total);
  } else if (dtype == 1) {
    mg_decode_kernel<__nv_bfloat16><<<blocks_for(total), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(p),
        static_cast<const __nv_bfloat16*>(o),
        static_cast<const float*>(cmat), static_cast<__nv_bfloat16*>(out),
        k, n, total);
  } else {
    return bad_dtype();
  }
  return static_cast<int>(cudaGetLastError());
}

// queries [k, B, F] (dtype_x); coeffs [r, k] fp32; weights [r, F, V]
// (dtype_w); out [r, B, V] in dtype_x
int repro_fused_encode_forward(const void* x, const void* C, const void* w,
                               void* out, int k, int r, int B, int F, int V,
                               int dtype_x, int dtype_w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r <= 0 || B <= 0 || V <= 0) return static_cast<int>(cudaGetLastError());
  if (dtype_x == 0 && dtype_w == 0) {
    launch_fused<float, float>(x, C, w, out, k, r, B, F, V, s);
  } else if (dtype_x == 0 && dtype_w == 1) {
    launch_fused<float, __nv_bfloat16>(x, C, w, out, k, r, B, F, V, s);
  } else if (dtype_x == 1 && dtype_w == 0) {
    launch_fused<__nv_bfloat16, float>(x, C, w, out, k, r, B, F, V, s);
  } else if (dtype_x == 1 && dtype_w == 1) {
    launch_fused<__nv_bfloat16, __nv_bfloat16>(x, C, w, out, k, r, B, F, V,
                                               s);
  } else {
    return bad_dtype();
  }
  return static_cast<int>(cudaGetLastError());
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
