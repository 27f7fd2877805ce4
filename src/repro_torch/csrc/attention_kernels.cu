// Attention kernels of the coded LM serving path for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (see repro_torch/kernels/_build.py).
//
// Every entry point takes device pointers and a cudaStream_t, launches on that
// stream without synchronising, allocates nothing (the wrapper allocates the
// output and any scratch), and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch (a negative code is a failed driver
// call, see repro_error_string).  Element types: dtype code 0 = float32, 1 =
// bfloat16.  Scores, the online softmax and every accumulation run in fp32;
// the output is written in the input type.
//
// Kernels in this file:
//   flash_wgmma_kernel    replace repro/kernels/flash_attention.py:
//   flash_kernel          flash_attention (B7, prefill attention): bf16 on
//                         the tensor cores (wgmma fed by TMA), fp32 in SIMT
//   decode_cluster_kernel replaces repro/kernels/decode_attention.py:
//                         decode_attention (B8, one-token attention over a
//                         KV cache): one launch, the split sweep combined
//                         inside a thread-block cluster
//
// Built with -DREPRO_CHECKED (kernels/_build.py: library(checked=True)),
// REPRO_CHECK(cond) prints the failed condition and traps; otherwise it is
// empty.  It guards the q, K / V and output indices of all three kernels,
// the tiles' shared-memory offsets, and the cluster combine's indices.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <stdio.h>

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

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr float kNegInf = -1e30f;   // the reference's mask value

// 16-byte global loads: N elements of T per uint4, widened to fp32 and
// multiplied by `scale` (1 for keys and values: exact) into shared memory.
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };

template <typename T>
__device__ __forceinline__ void widen(const uint4& raw, float scale,
                                      float* dst);
template <>
__device__ __forceinline__ void widen<float>(const uint4& raw, float scale,
                                             float* dst) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(raw.x) * scale, __uint_as_float(raw.y) * scale,
                  __uint_as_float(raw.z) * scale, __uint_as_float(raw.w) * scale);
}

// Copy rows [0, n_store) (n_store <= ROWS) of two [rows, HD] tiles (row r
// at base + r * stride, for a and b alike) into shared memory as fp32 (row
// strides sta, stb); rows >= n_valid are zero-filled and never read, so a
// masked P.V term is 0 * 0.  Each thread issues up to 4 16-byte loads of
// each tile before it stores any, so the loads of a tile are in flight
// together instead of one dependent load per element.  b may be null (one
// tile).  Rows start 16-byte aligned (the wrappers check the pointers; HD
// and the row strides are multiples of 8 elements).  `limit`: the elements
// of the tensors from a (and from b) on, for the checked build's guards.
template <typename T, int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_tiles(const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           int64_t stride, int n_valid,
                                           int n_store, float scale,
                                           float* sa, int sta, float* sb,
                                           int stb, int64_t limit) {
  constexpr int N = Vec<T>::N;
  constexpr int CPR = HD / N;                    // chunks per row
  constexpr int TOTAL = ROWS * CPR;
  constexpr int PER = (TOTAL + THREADS - 1) / THREADS;
  constexpr int BATCH = PER < 4 ? PER : 4;
  for (int j0 = 0; j0 < PER; j0 += BATCH) {
    uint4 ra[BATCH], rb[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int c = threadIdx.x + (j0 + j) * THREADS;
      const int r = c / CPR, d = (c % CPR) * N;
      ra[j] = rb[j] = make_uint4(0u, 0u, 0u, 0u);
      if (c < TOTAL && r < n_valid) {
        const int64_t off = r * stride + d;
        REPRO_CHECK(off >= 0 && off + N <= limit);
        ra[j] = *reinterpret_cast<const uint4*>(a + off);
        if (b != nullptr) rb[j] = *reinterpret_cast<const uint4*>(b + off);
      }
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const int c = threadIdx.x + (j0 + j) * THREADS;
      const int r = c / CPR, d = (c % CPR) * N;
      if (c < TOTAL && r < n_store) {
        widen<T>(ra[j], scale, sa + r * sta + d);
        if (b != nullptr) widen<T>(rb[j], 1.f, sb + r * stb + d);
      }
    }
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// ------------------------------------------------------------ flash, fp32 --
// out[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h / rep]) v[b, j, ...]
// over the keys j that the masks keep: j < Sk, j <= i (causal) and
// j > i - window (sliding window).  q [B, Sq, H, hd], k/v [B, Sk, KV, hd].
//
// The fp32 route of B7 (bf16 takes flash_wgmma_kernel below).  Bound on the
// H100: at the prefill shapes (Sq = Sk up to ~1k, hd 64) the work is
// ~Sq^2 H hd operations against ~(Sq H + 2 Sk KV) hd bytes, so the bound is
// operations.  It computes in SIMT fp32 (the fp32 tests hold it to 2e-5,
// which tensor-core bf16/TF32 inputs would not meet), so in practice it is
// bound by shared-memory traffic feeding the FMAs.
// Design: the TPU kernel carries m / l / acc across a sequential KV grid
// axis; Hopper blocks run in parallel, so a block owns one (b, h, 32-row
// query tile) and loops over 32-key tiles itself, with m / l / acc in
// registers.  Four threads share a query row (row max and sum by two warp
// shuffles); each thread owns 8 of the tile's 32 scores and hd/4 output
// columns as float4 chunks, so the score loop reads a q float4 once for 8
// key float4s and the P.V loop reads V as float4s.  Row strides are padded
// (hd + 4 floats) so the float4 reads of 8 rows or 4 keys hit distinct
// banks.  Causal and window masks bound the tile loop: tiles wholly above
// the diagonal or left of the window are never loaded.  The ragged Sq / Sk
// edges are masked in the loads (nothing is padded, no load passes Sk), and
// a masked score gives p = 0 explicitly, so a row that meets a wholly
// masked tile first keeps m = -1e30, l = 0, acc = 0 instead of garbage.
constexpr int kFlashThreads = 128;
constexpr int kBQ = 32;   // query rows per block: 4 threads per row
constexpr int kBK = 32;   // keys per tile: 8 scores per thread

template <int HD>
constexpr int flash_smem_floats() {
  return 2 * kBQ * (HD + 4) + kBK * HD + kBQ * (kBK + 1);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kFlashThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
             int H, int KV, int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  constexpr int QS = HD + 4;             // padded row stride of q and k
  float* qs = reinterpret_cast<float*>(smem4);   // [kBQ][QS]
  float* ks = qs + kBQ * QS;                     // [kBK][QS]
  float* vs = ks + kBK * QS;                     // [kBK][HD]
  float* ps = vs + kBK * HD;                     // [kBQ][kBK + 1]

  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, row = tid >> 2, cg = tid & 3;
  const int qpos = q0 + row;
  const int64_t q_row = static_cast<int64_t>(H) * HD;
  const int64_t kv_row = static_cast<int64_t>(KV) * HD;
  // the tensors' extents (gridDim.z = B), for the checked build's guards
  const int64_t q_n = static_cast<int64_t>(gridDim.z) * Sq * q_row;
  const int64_t kv_n = static_cast<int64_t>(gridDim.z) * Sk * kv_row;
  REPRO_CHECK(h < H && kvh < KV && q0 < Sq);
  const int64_t q_at = static_cast<int64_t>(b) * Sq * q_row + h * HD;
  const int64_t kv_at = static_cast<int64_t>(b) * Sk * kv_row + kvh * HD;
  const T* qb = q + q_at;
  const T* kb_ = k + kv_at;
  const T* vb = v + kv_at;

  load_tiles<T, HD, kBQ, kFlashThreads>(qb + q0 * q_row, nullptr, q_row,
                                        Sq - q0, kBQ, scale, qs, QS, nullptr,
                                        0, q_n - q_at - q0 * q_row);

  // the key tiles any row of this block can see
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / kBK, t_end = (k_end + kBK - 1) / kBK;

  constexpr int NC = HD / 16;            // float4 output chunks per thread
  float4 acc[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = kNegInf, l = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int kb = t * kBK;
    __syncthreads();                     // last tile's reads (and q) done
    load_tiles<T, HD, kBK, kFlashThreads>(kb_ + kb * kv_row, vb + kb * kv_row,
                                          kv_row, Sk - kb, kBK, 1.f, ks, QS,
                                          vs, HD, kv_n - kv_at - kb * kv_row);
    __syncthreads();

    // scores of keys cg + 4 j, j < 8
    float s[kBK / 4];
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) s[j] = 0.f;
    const float4* q4 = reinterpret_cast<const float4*>(qs + row * QS);
#pragma unroll 4
    for (int d4 = 0; d4 < HD / 4; ++d4) {
      const float4 a = q4[d4];
#pragma unroll
      for (int j = 0; j < kBK / 4; ++j) {
        const float4 kk = reinterpret_cast<const float4*>(
            ks + (cg + 4 * j) * QS)[d4];
        s[j] = dot4(a, kk, s[j]);
      }
    }
    float mt = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      const int kp = kb + cg + 4 * j;
      bool valid = kp < Sk && qpos < Sq;
      if (causal) valid = valid && kp <= qpos;
      if (window) valid = valid && kp > qpos - window;
      s[j] = valid ? s[j] : kNegInf;
      mt = fmaxf(mt, s[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    float lt = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / 4; ++j) {
      const float p = s[j] == kNegInf ? 0.f : expf(s[j] - m_new);
      ps[row * (kBK + 1) + cg + 4 * j] = p;
      lt += p;
    }
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    l = l * corr + lt;
    m = m_new;
    __syncwarp();                        // a row's 4 threads share a warp

#pragma unroll
    for (int j = 0; j < NC; ++j) {
      acc[j].x *= corr; acc[j].y *= corr; acc[j].z *= corr; acc[j].w *= corr;
    }
    REPRO_CHECK(row < kBQ && cg + 4 * (NC - 1) < HD / 4);
    for (int c = 0; c < kBK; ++c) {
      const float p = ps[row * (kBK + 1) + c];
      const float4* v4 = reinterpret_cast<const float4*>(vs + c * HD);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float4 vv = v4[cg + 4 * j];
        acc[j].x = fmaf(p, vv.x, acc[j].x);
        acc[j].y = fmaf(p, vv.y, acc[j].y);
        acc[j].z = fmaf(p, vv.z, acc[j].z);
        acc[j].w = fmaf(p, vv.w, acc[j].w);
      }
    }
  }

  if (qpos < Sq) {
    const float den = fmaxf(l, 1e-30f);
    const int64_t o_at = q_at + qpos * q_row;
    T* o = out + o_at;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int d = 4 * (cg + 4 * j);
      REPRO_CHECK(o_at + d + 4 <= q_n);
      o[d] = from_f32<T>(acc[j].x / den);
      o[d + 1] = from_f32<T>(acc[j].y / den);
      o[d + 2] = from_f32<T>(acc[j].z / den);
      o[d + 3] = from_f32<T>(acc[j].w / den);
    }
  }
}

// ------------------------------------------------------------ flash, bf16 --
// The bf16 route of B7: the function flash_kernel computes, on the tensor
// cores.  Replaces repro/kernels/flash_attention.py:flash_attention for bf16
// q / k / v.
//
// Bound on the H100: operations.  At the main-path shape (q [1, 910, 14, 64],
// k / v [1, 910, 2, 64], causal) the mask keeps 414,505 (query, key) pairs
// per head; QK^T and PV take 4 hd operations a pair, 1.49 GFLOP, 1.50 us at
// 989 TFLOP/s, against 3.7 MB read and written (1.1 us at 3.35 TB/s).  A
// 910-token prompt makes only 210 blocks of 64 query rows, ~4 key tiles of
// 128 each on average (8 for the longest), so the pace is set by one tile's
// latency (two short wgmma chains and the softmax between them) and by the
// longest, diagonal blocks, not by the 1.5 us.  The design keeps both
// products on the tensor cores, copies tile t + 1 while tile t computes, and
// launches the longest causal blocks first.
// Design: one warpgroup (128 threads) owns one (b, h, 64-row query tile).
// - TMA: Q is copied once; K / V tiles of 128 keys stream through a ring of
//   two stages in shared memory, one mbarrier per stage, and thread 0 issues
//   the copy of tile t + 1 before the warpgroup waits for tile t.  The
//   tensor maps are 4-D over [B, S, heads, hd] with a (1, rows, 1, hd) box,
//   so a ragged Sq / Sk edge is zero-filled by the copy engine and never
//   reads the next batch row or head.  The swizzle follows the row width:
//   64B for hd 32, 128B for hd 64, two 64-column boxes with 128B for hd 128;
//   tiles start on 1024-byte boundaries.
// - S = Q K^T: wgmma m64n128k16, Q and K (stored [128 keys][hd], the
//   K-major B operand) from shared memory, hd / 16 k-steps.  Scores are
//   scaled in fp32 after the product (hd^-0.5 is not exact in bf16 for hd 32
//   or 128), by scale * log2(e), so the softmax runs on exp2.
// - O += P V: wgmma m64n{hd}k16 with P from registers: the fp32 scores of a
//   thread are rounded to bf16 pairs in the A operand's register layout (as
//   FlashAttention-3 does; the one rounding the fp32 route does not make),
//   and V ([128 keys][hd], MN-major) from shared memory with the transpose
//   bit, 8 k-steps.
// - m, l and O stay in fp32 registers.  A row's scores sit on the 4 threads
//   of a quad, so its max and sum take two __shfl_xor_sync.
// - Masks: tiles wholly above the diagonal or left of the window are never
//   loaded; only a tile that a mask crosses, or that passes Sk (a
//   zero-filled key scores 0, not -1e30), tests each element, with row and
//   column from the accumulator's fragment layout.  A masked score gives
//   p = 0, so a row whose first tiles are wholly masked keeps m = -1e30,
//   l = 0, O = 0.
// - Tiles of 128 keys, not 64: on the main-path shape the kernel took 5%
//   less device time (PERF.md); 145 KB of shared memory at hd 128.
// - A copy that never lands (a bad tensor map) traps after ~2 s instead of
//   hanging the card.
constexpr int kTcThreads = 128;   // one warpgroup
constexpr int kTcBQ = 64;         // query rows per block: wgmma's M
constexpr int kTcBK = 128;        // keys per tile: the N of S = Q K^T
constexpr long long kHangCycles = 4000000000LL;   // ~2 s: mbar_wait traps

// Columns per TMA box (one swizzle row of 64 or 128 bytes) and the wgmma
// descriptor's matching layout type (1 = 128B swizzle, 2 = 64B).
template <int HD> struct TcLayout;
template <> struct TcLayout<32> {
  static constexpr int kBox = 32, kSwizzle = 2;
};
template <> struct TcLayout<64> {
  static constexpr int kBox = 64, kSwizzle = 1;
};
template <> struct TcLayout<128> {
  static constexpr int kBox = 64, kSwizzle = 1;
};

// Q, two stages of K and V, three mbarriers, and room to align to 1024
template <int HD>
__host__ __device__ constexpr int tc_smem_bytes() {
  return (kTcBQ + 4 * kTcBK) * HD * 2 + 3 * 8 + 1024;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
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
    } else if (clock64() - t0 > kHangCycles) {
      __trap();
    }
  }
}

// One TMA box of a 4-D map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (in 16-byte units) and the swizzle layout type
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(layout) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads of an accumulator above the wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, A and B K-major in shared
// memory
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 32] += A[64 x 16] . B[16 x 32], A (bf16 pairs) in registers,
// B MN-major in shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A (bf16 pairs) in registers,
// B MN-major in shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A (bf16 pairs) in registers,
// B MN-major in shared memory (the transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// Copy the K and V tiles of keys [k0, k0 + kTcBK) of kv-head g, batch row b,
// into one ring stage (K, then V), completing on that stage's barrier
template <int HD>
__device__ __forceinline__ void load_kv_tile(uint8_t* stage,
                                             const CUtensorMap* tk,
                                             const CUtensorMap* tv,
                                             uint64_t* bar, int g, int k0,
                                             int b) {
  constexpr int BOX = TcLayout<HD>::kBox, T_BYTES = kTcBK * HD * 2;
  mbar_expect_tx(bar, 2 * T_BYTES);
#pragma unroll
  for (int x = 0; x < HD / BOX; ++x) {
    tma_load(stage + x * kTcBK * BOX * 2, tk, bar, x * BOX, g, k0, b);
    tma_load(stage + T_BYTES + x * kTcBK * BOX * 2, tv, bar, x * BOX, g, k0,
             b);
  }
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
flash_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                   __grid_constant__ const CUtensorMap tk,
                   __grid_constant__ const CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, int Sq, int Sk, int H,
                   int KV, int causal, int window, float scale_log2) {
  constexpr int BOX = TcLayout<HD>::kBox;
  constexpr int SWZ = TcLayout<HD>::kSwizzle;
  constexpr int NBOX = HD / BOX;          // boxes per row of a tile
  constexpr int ROW = BOX * 2;            // bytes per box row (the swizzle)
  constexpr int KPB = BOX / 16;           // k-steps per box
  constexpr int Q_BYTES = kTcBQ * HD * 2, T_BYTES = kTcBK * HD * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  uint8_t* kv = qs + Q_BYTES;   // stage s: K at kv + 2 s T_BYTES, V after it
  uint64_t* bar = reinterpret_cast<uint64_t*>(kv + 4 * T_BYTES);  // Q, s0, s1

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;   // longest first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the TMA boxes' coordinates, and Q, the ring and the barriers inside the
  // dynamic shared memory (the copy engine bounds each box by its map)
  REPRO_CHECK(q0 >= 0 && q0 < Sq && h < H && kvh < KV);
  REPRO_CHECK(reinterpret_cast<uint8_t*>(bar + 3) <=
              smem_raw + tc_smem_bytes<HD>());
  // the key tiles any row of this block can see
  const int q_last = min(q0 + kTcBQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / kTcBK, t_end = (k_end + kTcBK - 1) / kTcBK;

  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_init(&bar[2], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar[0], Q_BYTES);
#pragma unroll
    for (int x = 0; x < NBOX; ++x)
      tma_load(qs + x * kTcBQ * ROW, &tq, &bar[0], x * BOX, h, q0, b);
    if (t_begin < t_end)
      load_kv_tile<HD>(kv, &tk, &tv, &bar[1], kvh, t_begin * kTcBK, b);
  }

  // accumulator fragment: this thread holds rows row0 and row0 + 8 of the
  // tile, columns 8 j + col0 and + 1 of every 8 (element 4 j + e: row
  // e >> 1, column e & 1)
  const int row0 = q0 + warp * 16 + (lane >> 2), col0 = 2 * (lane & 3);
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(&bar[0], 0);
  for (int t = t_begin; t < t_end; ++t) {
    const int i = t - t_begin, stage = i & 1;
    // the other stage held tile t - 1, whose reads ended at the last
    // iteration's __syncthreads
    REPRO_CHECK(t * kTcBK < Sk);
    if (tid == 0 && t + 1 < t_end)
      load_kv_tile<HD>(kv + (stage ^ 1) * 2 * T_BYTES, &tk, &tv,
                       &bar[1 + (stage ^ 1)], kvh, (t + 1) * kTcBK, b);
    mbar_wait(&bar[1 + stage], (i >> 1) & 1);
    const uint8_t* ks = kv + stage * 2 * T_BYTES;
    const uint8_t* vs = ks + T_BYTES;

    float s[kTcBK / 2];
#pragma unroll
    for (int j = 0; j < kTcBK / 2; ++j) s[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk % KPB) * 32;
      wgmma_ss(s,
               smem_desc(qs + (kk / KPB) * kTcBQ * ROW + off, 16, 8 * ROW,
                         SWZ),
               smem_desc(ks + (kk / KPB) * kTcBK * ROW + off, 16, 8 * ROW,
                         SWZ),
               kk > 0);
    }
    wgmma_commit_wait();
    reg_fence(s);

    const int kb = t * kTcBK;
    const bool edge = kb + kTcBK > Sk ||
                      (causal && kb + kTcBK - 1 > q0) ||
                      (window && kb <= q_last - window);
#pragma unroll
    for (int j = 0; j < kTcBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale_log2;
        if (edge) {
          const int row = row0 + 8 * (e >> 1);
          const int col = kb + 8 * j + col0 + (e & 1);
          bool ok = col < Sk;
          if (causal) ok = ok && col <= row;
          if (window) ok = ok && col > row - window;
          if (!ok) x = kNegInf;
        }
        s[4 * j + e] = x;
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < kTcBK / 8; ++j)
        mt = fmaxf(mt, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[r], mt);
      corr[r] = exp2f(m[r] - m_new);
      float lt = 0.f;
#pragma unroll
      for (int j = 0; j < kTcBK / 8; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int idx = 4 * j + 2 * r + c;
          const float p = s[idx] == kNegInf ? 0.f : exp2f(s[idx] - m_new);
          s[idx] = p;
          lt += p;
        }
      }
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      l[r] = l[r] * corr[r] + lt;
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) o[j] *= corr[(j >> 1) & 1];
    // P as the A operand of m64nNk16: k-step kk takes score columns
    // 16 kk .. 16 kk + 15, i.e. accumulator chunks 2 kk and 2 kk + 1
    uint32_t pa[kTcBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBK / 16; ++kk)
      wgmma_rs(o, pa[kk],
               smem_desc(vs + kk * 16 * ROW, kTcBK * ROW, 8 * ROW, SWZ));
    wgmma_commit_wait();
    reg_fence(o);
    __syncthreads();                     // this stage's reads are done
  }

  const int64_t q_row = static_cast<int64_t>(H) * HD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= Sq) continue;
    const float den = fmaxf(l[r], 1e-30f);
    const int64_t o_at = (static_cast<int64_t>(b) * Sq + row) * q_row +
                         h * HD;
    __nv_bfloat16* orow = out + o_at;
    REPRO_CHECK(row >= 0 &&
                o_at + HD <= static_cast<int64_t>(gridDim.z) * Sq * q_row);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col0) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] / den,
                                o[4 * j + 2 * r + 1] / den);
  }
}

// ---------------------------------------------------------------- decode ---
// out[b, h] = softmax_j(scale * q[b, h] . kc[b, j, g]) vc[b, j, g] over the
// cached slots j <= pos[b] (j < n_valid = min(pos[b] + 1, S)), g = h / rep.
// q [B, H, hd], caches [B, S, KV, hd], pos [B] int32.  Replaces
// repro/kernels/decode_attention.py:decode_attention (B8).
//
// Bound on the H100: bytes.  A call reads each valid cache row of K and V
// once (2 x n_valid x KV x hd elements per batch row) and does 4 operations
// per (query head, slot) pair and hd, ~rep operations per byte read, far
// below the ~295 where the card turns compute-bound.  At the LM path's
// shape ([4, 1280, 14, 64] bf16, pos [300, 1279, 517, 1031]) that is 1.6 MB,
// 0.48 us at 3.35 TB/s: a single launch (~1.35 us on this card) is above it.
// Design: one launch, no scratch in device memory, no second kernel.
// - Grid (cluster, KV, B): the CTAs of one (b, kv-head) form a thread-block
//   cluster of 8 or 16 along x (decode_attention.py picks the size once per
//   instance from cudaOccupancyMaxActiveClusters).  Each CTA takes an equal
//   share of the n_valid slots, a multiple of 16 (cta_range below; the
//   Python plan computes the same ranges), so the work follows pos[b] on
//   the device and a short row leaves whole CTAs idle instead of splitting
//   evenly over S.
// - Loads: the CTA's share is cut into 16-slot chunks, chunk c going to
//   warp c % 4.  Each warp copies its own chunks' K and V rows with 16-byte
//   cp.async into its own ring (up to 4 chunks; ~72 KB for the CTA), every
//   stage at entry, so the sweep needs no block barrier, only __syncwarp.
//   A row past n_valid is never read (the copy of the last chunk's tail
//   zero-fills instead).  The rows stay in the cache's dtype in shared
//   memory, padded by 16 bytes so the ldmatrix / float4 reads of 8 rows hit
//   distinct banks.  cp.async and not
//   TMA: a TMA box has a fixed row count, so the last box of a CTA would
//   read rows past pos[b], and its tensor maps would be encoded on the
//   host on every call.
// - Arithmetic: each warp keeps its own online softmax (m, l, O) over its
//   chunks for the rep <= 16 query heads of the KV head.  bf16: S = Q K^T and O += P V on the tensor cores with
//   mma.sync m16n8k16 (the rep heads are the 16 rows, zero-padded; wgmma's
//   64 rows cannot be filled by a decode), K and V fragments by ldmatrix
//   (V transposed), Q's fragments held in registers (loaded before pos is
//   read, so the two loads overlap), S's even and odd k-steps in separate
//   accumulators (half the chain of dependent mma.sync), P taken from the
//   S accumulator's registers as the A fragment and rounded to bf16 (B7's
//   one rounding).  fp32: the same structure in SIMT fp32, which holds the
//   2e-5 tolerance.  Scores carry scale * log2(e), so the softmax runs on
//   exp2.
// - Combine: the four warps' (m, l, O) merge in shared memory into the
//   CTA's, and each CTA stores its values straight into the shared memory
//   of the CTA that owns them (distributed shared memory, O as float4s;
//   each CTA owns an equal share of the rep x hd outputs, every CTA gets m
//   and l of every row).  One cluster barrier later each CTA rescales what it received
//   and writes its outputs in q's dtype, reading only its own shared
//   memory, so no second barrier holds a CTA until its peers are done.  A
//   barrier phase that every CTA arrives at on entry and waits on before
//   its first remote store makes sure no peer is written before it runs.
constexpr int kDecThreads = 128;                  // four warps
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecChunk = 16;                     // slots per warp step
constexpr int kMaxRep = 16;                       // rows of m16n8k16
constexpr int kMaxCluster = 16;
constexpr int kDecRingBytes = 73728;              // ring budget per CTA

template <typename T, int HD> struct DecLayout {
  static constexpr int RS = HD * static_cast<int>(sizeof(T)) + 16;  // row
  static constexpr int STAGE = 2 * kDecChunk * RS;   // one chunk: K, V
  // stages of each warp's own ring
  static constexpr int NST = kDecRingBytes / (kDecWarps * STAGE) < 1 ? 1
                             : kDecRingBytes / (kDecWarps * STAGE) > 4 ? 4
                             : kDecRingBytes / (kDecWarps * STAGE);
  static constexpr int RING = kDecWarps * NST * STAGE;
  // per-warp partials (O [16][HD], m [16], l [16]), aliasing the ring
  static constexpr int PART = kDecWarps * kMaxRep * (HD + 2) * 4;
  static constexpr int WORK = RING > PART ? RING : PART;
  // the fp32 route's pre-scaled Q [16][HD]
  static constexpr int QS = std::is_same<T, float>::value ? kMaxRep * HD * 4
                                                          : 0;
  // what the cluster's CTAs send this one: their O for the outputs it owns
  // ([cs][4 per4], per4 = ceil(rep HD / 4 / cs) column quads), and m and l
  // of every row ([cs][16] each)
  static constexpr int RECV =
      (kMaxRep * HD + 4 * kMaxCluster + 2 * kMaxCluster * kMaxRep) * 4;
  static constexpr int SMEM = WORK + QS + RECV;
};

// Split arrive / wait on the cluster barrier (all threads of every CTA)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {   // release
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {     // acquire
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Slots [begin, end) of CTA `rank` of a cluster of `cs`: ceil(n_valid / cs)
// rounded up to a multiple of kDecChunk each (decode_attention.py:cta_slots
// is the same arithmetic)
__device__ __forceinline__ void cta_range(int n_valid, int cs, int rank,
                                          int* begin, int* end) {
  const int per = (n_valid + cs - 1) / cs;
  const int share = (per + kDecChunk - 1) / kDecChunk * kDecChunk;
  *begin = min(rank * share, n_valid);
  *end = min(*begin + share, n_valid);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One warp copies slots [s0, s0 + kDecChunk) ∩ [s0, end) of K and V (head
// g, batch row b) into a stage of its ring: K rows at stage + i * RS, V
// rows after them.  Rows from `end` on are zero-filled without a read (a
// masked P.V term is then 0 * 0, never 0 * garbage).
template <typename T, int HD>
__device__ __forceinline__ void load_chunk(uint8_t* stage,
                                           const T* __restrict__ kb,
                                           const T* __restrict__ vb,
                                           int64_t row, int s0, int end) {
  using L = DecLayout<T, HD>;
  constexpr int CPR = HD * static_cast<int>(sizeof(T)) / 16;   // 16 B / row
  const int n = min(kDecChunk, end - s0);
#pragma unroll
  for (int c = threadIdx.x & 31; c < kDecChunk * CPR; c += 32) {
    const int r = c / CPR, x = c % CPR;
    const bool valid = r < n;
    REPRO_CHECK(!valid || (s0 + r >= 0 && s0 + r < end));
    const int64_t off = valid ? (s0 + r) * row + x * (16 / sizeof(T)) : 0;
    cp_async16(stage + r * L::RS + x * 16, kb + off, valid);
    cp_async16(stage + (kDecChunk + r) * L::RS + x * 16, vb + off, valid);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// D[16 x 8] += A[16 x 16] . B[16 x 8], bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's online softmax over its chunks, for the bf16 route: rows g and
// g + 8 of the 16 (query heads), m and l of each (l summed over this
// thread's columns only; the quad's sum is taken once, at the end), and
// the O accumulator fragment (columns 8 j + 2 t and + 1 of rows g, g + 8).
template <int HD>
struct MmaState {
  uint32_t qa[HD / 16][4];   // Q's A fragments, one per 16-column k-step
  float o[HD / 8][4];
  float m[2], l[2];
};

template <int HD>
__device__ __forceinline__ void mma_init(MmaState<HD>& st,
                                         const __nv_bfloat16* __restrict__ qg,
                                         int rep) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e & 1), col = 16 * kk + 2 * t + 8 * (e >> 1);
      st.qa[kk][e] = row < rep ? *reinterpret_cast<const uint32_t*>(
                                     qg + row * HD + col)
                               : 0u;
    }
  }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[j][e] = 0.f;
  st.m[0] = st.m[1] = kNegInf;
  st.l[0] = st.l[1] = 0.f;
}

// One 16-slot chunk (slots s0 .. s0 + 15, those >= end masked) whose K rows
// sit at ks and V rows at vs, row stride RS bytes
template <int HD, int RS>
__device__ __forceinline__ void mma_chunk(MmaState<HD>& st,
                                          const uint8_t* ks,
                                          const uint8_t* vs, int s0, int end,
                                          float scale_log2) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;   // ldmatrix: matrix, its row
  // even and odd k-steps accumulate apart, halving the chain of dependent
  // mma.sync, and are summed after
  float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  float s2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    // matrices (slots 0-7, cols lo), (0-7, hi), (8-15, lo), (8-15, hi)
    uint32_t kf[4];
    ldmatrix_x4(kf, ks + (mr + 8 * (mi >> 1)) * RS +
                        (16 * kk + 8 * (mi & 1)) * 2);
    float (&acc)[2][4] = kk & 1 ? s2 : s;
    mma_bf16(acc[0], st.qa[kk], kf[0], kf[1]);
    mma_bf16(acc[1], st.qa[kk], kf[2], kf[3]);
  }
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] += s2[nb][e];
  const bool edge = s0 + kDecChunk > end;
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[nb][e] * scale_log2;
      if (edge && s0 + 8 * nb + 2 * t + (e & 1) >= end) x = kNegInf;
      s[nb][e] = x;
    }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mt = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                     fmaxf(s[1][2 * r], s[1][2 * r + 1]));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(st.m[r], mt);
    corr[r] = exp2f(st.m[r] - m_new);
    float lt = 0.f;
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float x = s[nb][2 * r + c];
        const float p = x == kNegInf ? 0.f : exp2f(x - m_new);
        s[nb][2 * r + c] = p;
        lt += p;
      }
    st.l[r] = st.l[r] * corr[r] + lt;
    st.m[r] = m_new;
  }
  // P as the A fragment: rows g / g + 8, slots 2t (+1) and 8 + 2t (+1)
  const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                          pack_bf16(s[0][2], s[0][3]),
                          pack_bf16(s[1][0], s[1][1]),
                          pack_bf16(s[1][2], s[1][3])};
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[j][e] *= corr[e >> 1];
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) {
    // matrices (slots 0-7, cols 16 j..), (8-15, 16 j..), (0-7, 16 j + 8..),
    // (8-15, 16 j + 8..), transposed into B fragments
    uint32_t vf[4];
    ldmatrix_x4_trans(vf, vs + (mr + 8 * (mi & 1)) * RS +
                              (16 * j + 8 * (mi >> 1)) * 2);
    mma_bf16(st.o[2 * j], pa, vf[0], vf[1]);
    mma_bf16(st.o[2 * j + 1], pa, vf[2], vf[3]);
  }
}

// Write the warp's (m, l, O) to its partial slot: O [16][HD], m [16], l [16]
template <int HD>
__device__ __forceinline__ void mma_store(MmaState<HD>& st, float* wo,
                                          float* wm, float* wl) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = st.l[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (t == 0) {
      wm[g + 8 * r] = st.m[r];
      wl[g + 8 * r] = l;
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(wo + (g + 8 * r) * HD + 8 * j + 2 * t) =
          make_float2(st.o[j][2 * r], st.o[j][2 * r + 1]);
  }
}

// The fp32 route's warp state: lane owns columns lane + 32 j of all 16
// rows; scores of (row 2 i + (lane >> 4), slot lane & 15), i < 8, with m and
// l of those rows (l summed over this lane's slots; the half-warp's sum is
// taken at the end)
template <int HD>
struct SimtState {
  float o[kMaxRep][HD / 32];
  float m[8], l[8];
};

template <int HD>
__device__ __forceinline__ void simt_init(SimtState<HD>& st) {
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r)
#pragma unroll
    for (int j = 0; j < HD / 32; ++j) st.o[r][j] = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    st.m[i] = kNegInf;
    st.l[i] = 0.f;
  }
}

// One 16-slot chunk on the fp32 route; qs is Q [16][HD] fp32, pre-scaled
template <int HD, int RS>
__device__ __forceinline__ void simt_chunk(SimtState<HD>& st,
                                           const float* qs,
                                           const uint8_t* ks,
                                           const uint8_t* vs, int s0,
                                           int end) {
  const int lane = threadIdx.x & 31, c = lane & 15, h = lane >> 4;
  float s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = 0.f;
  const float4* k4 = reinterpret_cast<const float4*>(ks + c * RS);
#pragma unroll 4
  for (int d4 = 0; d4 < HD / 4; ++d4) {
    const float4 kk = k4[d4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      s[i] = dot4(reinterpret_cast<const float4*>(
                      qs + (2 * i + h) * HD)[d4], kk, s[i]);
  }
  const bool masked = s0 + c >= end;
  float p[8], corr[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float x = masked ? kNegInf : s[i];
    float mt = x;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
    const float m_new = fmaxf(st.m[i], mt);
    corr[i] = exp2f(st.m[i] - m_new);
    p[i] = masked ? 0.f : exp2f(x - m_new);
    st.l[i] = st.l[i] * corr[i] + p[i];
    st.m[i] = m_new;
  }
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    const float cr = __shfl_sync(0xffffffffu, corr[r >> 1], (r & 1) * 16);
#pragma unroll
    for (int j = 0; j < HD / 32; ++j) st.o[r][j] *= cr;
  }
#pragma unroll
  for (int cc = 0; cc < kDecChunk; ++cc) {
    const float* vrow = reinterpret_cast<const float*>(vs + cc * RS);
    float v[HD / 32];
#pragma unroll
    for (int j = 0; j < HD / 32; ++j) v[j] = vrow[lane + 32 * j];
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      const float pr = __shfl_sync(0xffffffffu, p[r >> 1], (r & 1) * 16 + cc);
#pragma unroll
      for (int j = 0; j < HD / 32; ++j) st.o[r][j] = fmaf(pr, v[j], st.o[r][j]);
    }
  }
}

template <int HD>
__device__ __forceinline__ void simt_store(SimtState<HD>& st, float* wo,
                                           float* wm, float* wl) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float l = st.l[i];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if ((lane & 15) == 0) {
      wm[2 * i + (lane >> 4)] = st.m[i];
      wl[2 * i + (lane >> 4)] = l;
    }
  }
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r)
#pragma unroll
    for (int j = 0; j < HD / 32; ++j) wo[r * HD + lane + 32 * j] = st.o[r][j];
}

// Four consecutive outputs in T (16 bytes of fp32, 8 of bf16)
template <typename T>
__device__ __forceinline__ void store4(T* p, float a, float b, float c,
                                       float d);
template <>
__device__ __forceinline__ void store4<float>(float* p, float a, float b,
                                              float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b,
                                                      float c, float d) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(a, b), pack_bf16(c, d));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kDecThreads)
decode_cluster_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, const int* __restrict__ pos,
                      T* __restrict__ out, int S, int KV, int rep,
                      float scale_log2) {
  using L = DecLayout<T, HD>;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) uint8_t dec_smem[];
  uint8_t* ring = dec_smem;
  float* wpart = reinterpret_cast<float*>(dec_smem);          // aliases ring
  float* qs = reinterpret_cast<float*>(dec_smem + L::WORK);    // fp32 route
  float* ro = reinterpret_cast<float*>(dec_smem + L::WORK + L::QS);
  float* rm = ro + kMaxRep * HD + 4 * kMaxCluster;             // [cs][16]
  float* rl = rm + kMaxCluster * kMaxRep;                      // [cs][16]

  // phase 0 of the cluster barrier: this CTA has started (a peer's shared
  // memory may be written only once it has)
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int g = blockIdx.y, b = blockIdx.z;
  const int H = KV * rep;
  const int tid = threadIdx.x, warp = tid >> 5;
  // the grid is (cluster, KV, B): q [B, H, HD], caches [B, S, KV, HD]
  REPRO_CHECK(cs == static_cast<int>(gridDim.x) && cs <= kMaxCluster &&
              rank < cs && g < KV && rep >= 1 && rep <= kMaxRep);
  REPRO_CHECK(L::RING <= L::WORK &&
              kDecWarps * kMaxRep * (HD + 2) * 4 <= L::WORK);
  const T* qg = q + (static_cast<int64_t>(b) * H + g * rep) * HD;
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  using State = typename std::conditional<kMma, MmaState<HD>,
                                          SimtState<HD>>::type;
  State st;                                // Q's loads overlap pos's
  if constexpr (kMma)
    mma_init<HD>(st, qg, rep);
  else
    simt_init<HD>(st);
  const int n_valid = max(0, min(pos[b] + 1, S));
  int begin, end;
  cta_range(n_valid, cs, rank, &begin, &end);
  REPRO_CHECK(begin >= 0 && begin <= end && end <= S);
  // this warp's chunks: c = warp, warp + 4, ... of the CTA's share
  const int n_chunks = (end - begin + kDecChunk - 1) / kDecChunk;
  const int n_mine = n_chunks > warp
                         ? (n_chunks - warp + kDecWarps - 1) / kDecWarps
                         : 0;
  const int64_t row = static_cast<int64_t>(KV) * HD;
  const T* kb = kc + static_cast<int64_t>(b) * S * row + g * HD;
  const T* vb = vc + static_cast<int64_t>(b) * S * row + g * HD;
  uint8_t* wring = ring + warp * L::NST * L::STAGE;

  // each warp fills its own ring, every stage at entry, one commit group a
  // stage, so the sweep needs no block barrier
#pragma unroll
  for (int k = 0; k < L::NST; ++k) {
    if (k < n_mine)
      load_chunk<T, HD>(wring + k * L::STAGE, kb, vb, row,
                        begin + (warp + k * kDecWarps) * kDecChunk, end);
    cp_async_commit();
  }

  if constexpr (!kMma) {
    // Q [16][HD] fp32, scaled by scale * log2(e), rows >= rep zero
    for (int i = tid; i < kMaxRep * HD; i += kDecThreads)
      qs[i] = i / HD < rep ? static_cast<float>(qg[i]) * scale_log2 : 0.f;
    __syncthreads();
  }

  for (int k = 0; k < n_mine; ++k) {
    cp_async_wait<L::NST - 1>();
    __syncwarp();                          // chunk k landed for every lane
    const uint8_t* kw = wring + (k % L::NST) * L::STAGE;
    const uint8_t* vw = kw + kDecChunk * L::RS;
    const int s0 = begin + (warp + k * kDecWarps) * kDecChunk;
    if constexpr (kMma)
      mma_chunk<HD, L::RS>(st, kw, vw, s0, end, scale_log2);
    else
      simt_chunk<HD, L::RS>(st, qs, kw, vw, s0, end);
    if (k + L::NST < n_mine) {
      __syncwarp();                        // the stage's reads are done
      load_chunk<T, HD>(wring + (k % L::NST) * L::STAGE, kb, vb, row,
                        s0 + L::NST * kDecWarps * kDecChunk, end);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();                         // the ring is free: partials

  constexpr int WP = kMaxRep * (HD + 2);   // floats of one warp's partial
  float* wo = wpart + warp * WP;
  if constexpr (kMma)
    mma_store<HD>(st, wo, wo + kMaxRep * HD, wo + kMaxRep * HD + kMaxRep);
  else
    simt_store<HD>(st, wo, wo + kMaxRep * HD, wo + kMaxRep * HD + kMaxRep);
  __syncthreads();

  // each value of the CTA's (m, l, O), merged from its warps' (m in the
  // log2 domain), stored straight into the shared memory of the CTA that
  // owns it: m and l of a row to every CTA, O four columns at a time to the
  // owner of those outputs
  const int n4 = rep * HD / 4, per4 = (n4 + cs - 1) / cs;
  cluster_wait();                          // phase 0: every CTA has started
  // what a CTA receives: O of its outputs ([cs][per4] float4s), m and l
  const int recv4 = (kMaxRep * HD + 4 * kMaxCluster) / 4;
  for (int x = tid; x < rep * cs; x += kDecThreads) {
    const int r = x / cs, c = x % cs;
    REPRO_CHECK(r < kMaxRep && c < cs && rank * kMaxRep + r <
                kMaxCluster * kMaxRep);
    float m = kNegInf, l = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w)
      m = fmaxf(m, wpart[w * WP + kMaxRep * HD + r]);
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w)
      l = fmaf(wpart[w * WP + kMaxRep * HD + kMaxRep + r],
               exp2f(wpart[w * WP + kMaxRep * HD + r] - m), l);
    cluster.map_shared_rank(rm, c)[rank * kMaxRep + r] = m;
    cluster.map_shared_rank(rl, c)[rank * kMaxRep + r] = l;
  }
  for (int i4 = tid; i4 < n4; i4 += kDecThreads) {
    const int r = 4 * i4 / HD;
    float wm[kDecWarps];
    float m = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      wm[w] = wpart[w * WP + kMaxRep * HD + r];
      m = fmaxf(m, wm[w]);
    }
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float wt = exp2f(wm[w] - m);
      const float4 v = reinterpret_cast<const float4*>(wpart + w * WP)[i4];
      o.x = fmaf(v.x, wt, o.x);
      o.y = fmaf(v.y, wt, o.y);
      o.z = fmaf(v.z, wt, o.z);
      o.w = fmaf(v.w, wt, o.w);
    }
    const int owner = i4 / per4;
    REPRO_CHECK(r < rep && owner < cs && (i4 + 1) * 4 <= kMaxRep * HD &&
                rank * per4 + i4 - owner * per4 < recv4);
    reinterpret_cast<float4*>(cluster.map_shared_rank(ro, owner))
        [rank * per4 + i4 - owner * per4] = o;
  }
  cluster_arrive();                        // phase 1: every partial landed
  cluster_wait();

  // the outputs this CTA owns, from its own shared memory (no peer is read,
  // so a CTA may exit as soon as it is done)
  T* ob = out + (static_cast<int64_t>(b) * H + g * rep) * HD;
  for (int j4 = tid; j4 < per4 && rank * per4 + j4 < n4;
       j4 += kDecThreads) {
    const int i4 = rank * per4 + j4, r = 4 * i4 / HD;
    REPRO_CHECK(r < rep && (cs - 1) * per4 + j4 < recv4 &&
                (static_cast<int64_t>(b) * H + g * rep) * HD + 4 * i4 + 4 <=
                    static_cast<int64_t>(gridDim.z) * H * HD);
    float mp[kMaxCluster];
    float m = kNegInf;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      if (c < cs) {
        mp[c] = rm[c * kMaxRep + r];
        m = fmaxf(m, mp[c]);
      }
    }
    float l = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      if (c < cs) {
        const float wt = exp2f(mp[c] - m);
        const float4 v = reinterpret_cast<const float4*>(ro)[c * per4 + j4];
        l = fmaf(rl[c * kMaxRep + r], wt, l);
        o.x = fmaf(v.x, wt, o.x);
        o.y = fmaf(v.y, wt, o.y);
        o.z = fmaf(v.z, wt, o.z);
        o.w = fmaf(v.w, wt, o.w);
      }
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    store4<T>(ob + 4 * i4, o.x * inv, o.y * inv, o.z * inv, o.w * inv);
  }
}

template <typename T, int HD>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         void* out, int B, int Sq, int Sk, int H, int KV,
                         int causal, int window, float scale,
                         cudaStream_t st) {
  const int smem = flash_smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_kernel<T, HD><<<grid, kFlashThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, KV, causal,
      window, scale);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, fetched from the driver at run time through the
// runtime's cudaGetDriverEntryPoint (no link against libcuda)
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// Negative return codes of the entry points: a driver call failed
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

// A 4-D map over a contiguous bf16 [B, S, heads, HD] tensor, innermost
// first, with boxes of (kBox columns, 1 head, `rows` positions, 1 batch row)
template <int HD>
CUresult encode_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int B,
                    int S, int heads, int rows) {
  const cuuint64_t dim[4] = {static_cast<cuuint64_t>(HD),
                             static_cast<cuuint64_t>(heads),
                             static_cast<cuuint64_t>(S),
                             static_cast<cuuint64_t>(B)};
  const cuuint64_t stride[3] = {dim[0] * 2, dim[0] * dim[1] * 2,
                                dim[0] * dim[1] * dim[2] * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(TcLayout<HD>::kBox), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dim, stride, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             TcLayout<HD>::kBox == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                      : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int HD>
int launch_flash_wgmma(const void* q, const void* k, const void* v, void* out,
                       int B, int Sq, int Sk, int H, int KV, int causal,
                       int window, float scale, cudaStream_t st) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return kErrNoEncode;
  // with no keys no K / V tile is loaded: map q, whose extents are valid
  const bool no_keys = Sk == 0;
  CUtensorMap tq, tk, tv;
  CUresult res = encode_map<HD>(enc, &tq, q, B, Sq, H, kTcBQ);
  if (res == CUDA_SUCCESS)
    res = encode_map<HD>(enc, &tk, no_keys ? q : k, B, no_keys ? Sq : Sk,
                         no_keys ? H : KV, kTcBK);
  if (res == CUDA_SUCCESS)
    res = encode_map<HD>(enc, &tv, no_keys ? q : v, B, no_keys ? Sq : Sk,
                         no_keys ? H : KV, kTcBK);
  if (res != CUDA_SUCCESS) return kErrEncode - static_cast<int>(res);
  constexpr int smem = tc_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kTcBQ - 1) / kTcBQ, H, B);
  flash_wgmma_kernel<HD><<<grid, kTcThreads, smem, st>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Sq, Sk, H, KV, causal,
      window, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory above 48 KB and clusters of 16 (non-portable) for
// one instance of decode_cluster_kernel, set once per device
constexpr int kMaxDevices = 64;

template <typename T, int HD>
cudaError_t decode_prepare() {
  static std::atomic<int> ready[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && ready[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(decode_cluster_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DecLayout<T, HD>::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(decode_cluster_kernel<T, HD>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err == cudaSuccess && dev < kMaxDevices)
    ready[dev].store(1, std::memory_order_release);
  return err;
}

// The launch configuration of a (cluster, KV, B) grid, clusters along x
struct DecodeConfig {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  DecodeConfig(int cluster, int KV, int B, int smem, cudaStream_t st) {
    cfg.gridDim = dim3(cluster, KV, B);
    cfg.blockDim = dim3(kDecThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <typename T, int HD>
cudaError_t launch_decode(const void* q, const void* kc, const void* vc,
                          const void* pos, void* out, int B, int S, int H,
                          int KV, int cluster, float scale, cudaStream_t st) {
  cudaError_t err = decode_prepare<T, HD>();
  if (err != cudaSuccess) return err;
  DecodeConfig dc(cluster, KV, B, DecLayout<T, HD>::SMEM, st);
  err = cudaLaunchKernelEx(&dc.cfg, decode_cluster_kernel<T, HD>,
                           static_cast<const T*>(q), static_cast<const T*>(kc),
                           static_cast<const T*>(vc),
                           static_cast<const int*>(pos), static_cast<T*>(out),
                           S, KV, H / KV, scale * 1.4426950408889634f);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t decode_capacity(int cluster, int* n_clusters) {
  cudaError_t err = decode_prepare<T, HD>();
  if (err != cudaSuccess) return err;
  DecodeConfig dc(cluster, 1, 1, DecLayout<T, HD>::SMEM, nullptr);
  return cudaOccupancyMaxActiveClusters(n_clusters,
                                        decode_cluster_kernel<T, HD>,
                                        &dc.cfg);
}

}  // namespace

extern "C" {

// q [B, Sq, H, hd], k/v [B, Sk, KV, hd] -> out [B, Sq, H, hd]; hd in
// {32, 64, 128}, H a multiple of KV.  The route follows the dtype: bf16
// runs flash_wgmma_kernel (tensor cores, TMA), fp32 flash_kernel (SIMT).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int B, int Sq, int Sk, int H, int KV,
                          int hd, int causal, int window, float scale,
                          int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
#define REPRO_FLASH(HD)                                                     \
  return static_cast<int>(launch_flash<float, HD>(                          \
      q, k, v, out, B, Sq, Sk, H, KV, causal, window, scale, st))
    if (hd == 32) REPRO_FLASH(32);
    if (hd == 64) REPRO_FLASH(64);
    if (hd == 128) REPRO_FLASH(128);
#undef REPRO_FLASH
  } else if (dtype == 1) {
#define REPRO_FLASH(HD)                                                     \
  return launch_flash_wgmma<HD>(q, k, v, out, B, Sq, Sk, H, KV, causal,     \
                                window, scale, st)
    if (hd == 32) REPRO_FLASH(32);
    if (hd == 64) REPRO_FLASH(64);
    if (hd == 128) REPRO_FLASH(128);
#undef REPRO_FLASH
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// q [B, H, hd], caches [B, S, KV, hd], pos [B] int32 -> out [B, H, hd];
// hd in {32, 64, 128}, H / KV <= 16; the CTAs of one (b, kv-head) form a
// cluster of `cluster` (1..16) CTAs.  The route follows the dtype: bf16 on
// the tensor cores (mma.sync), fp32 in SIMT.
int repro_decode_attention(const void* q, const void* kc, const void* vc,
                           const void* pos, void* out, int B, int S, int H,
                           int KV, int hd, int cluster, float scale,
                           int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (KV < 1 || H % KV != 0 || H / KV > kMaxRep || cluster < 1 ||
      cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_DECODE(T, HD)                                                \
  return static_cast<int>(launch_decode<T, HD>(q, kc, vc, pos, out, B, S,  \
                                               H, KV, cluster, scale, st))
  if (dtype == 0) {
    if (hd == 32) REPRO_DECODE(float, 32);
    if (hd == 64) REPRO_DECODE(float, 64);
    if (hd == 128) REPRO_DECODE(float, 128);
  } else if (dtype == 1) {
    if (hd == 32) REPRO_DECODE(__nv_bfloat16, 32);
    if (hd == 64) REPRO_DECODE(__nv_bfloat16, 64);
    if (hd == 128) REPRO_DECODE(__nv_bfloat16, 128);
  }
#undef REPRO_DECODE
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters of `cluster` CTAs of the (dtype, hd) instance of the
// decode kernel the current device can hold at once (0 when it cannot
// launch that cluster size)
int repro_decode_cluster_capacity(int hd, int dtype, int cluster,
                                  int* n_clusters) {
  *n_clusters = 0;
  if (cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_CAPACITY(T, HD) \
  return static_cast<int>(decode_capacity<T, HD>(cluster, n_clusters))
  if (dtype == 0) {
    if (hd == 32) REPRO_CAPACITY(float, 32);
    if (hd == 64) REPRO_CAPACITY(float, 64);
    if (hd == 128) REPRO_CAPACITY(float, 128);
  } else if (dtype == 1) {
    if (hd == 32) REPRO_CAPACITY(__nv_bfloat16, 32);
    if (hd == 64) REPRO_CAPACITY(__nv_bfloat16, 64);
    if (hd == 128) REPRO_CAPACITY(__nv_bfloat16, 128);
  }
#undef REPRO_CAPACITY
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
