// Attention kernels of the coded LM serving path for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (see repro_torch/kernels/_build.py).
//
// Every entry point takes device pointers and a cudaStream_t, launches on that
// stream without synchronising, allocates nothing (the wrapper allocates the
// output and any scratch), and returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.  Element types: dtype code 0 =
// float32, 1 = bfloat16.  Scores, the online softmax and every accumulation
// run in fp32; the output is written in the input type.
//
// Kernels in this file:
//   flash_kernel          replaces repro/kernels/flash_attention.py:
//                         flash_attention (B7, prefill attention)
//   decode_kernel         replaces repro/kernels/decode_attention.py:
//   decode_combine_kernel decode_attention (B8, one-token attention over a
//                         KV cache), the second pass of a split sweep
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

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
template <>
__device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& raw,
                                                     float scale, float* dst) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] =
      make_float4(a.x * scale, a.y * scale, b.x * scale, b.y * scale);
  reinterpret_cast<float4*>(dst)[1] =
      make_float4(c.x * scale, c.y * scale, d.x * scale, d.y * scale);
}

// Copy rows [0, n_store) (n_store <= ROWS) of two [rows, HD] tiles (row r
// at base + r * stride, for a and b alike) into shared memory as fp32 (row
// strides sta, stb); rows >= n_valid are zero-filled and never read, so a
// masked P.V term is 0 * 0.  Each thread issues up to 4 16-byte loads of
// each tile before it stores any, so the loads of a tile are in flight
// together instead of one dependent load per element.  b may be null (one
// tile).  Rows start 16-byte aligned (the wrappers check the pointers; HD
// and the row strides are multiples of 8 elements).
template <typename T, int HD, int ROWS, int THREADS>
__device__ __forceinline__ void load_tiles(const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           int64_t stride, int n_valid,
                                           int n_store, float scale,
                                           float* sa, int sta, float* sb,
                                           int stb) {
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

// ----------------------------------------------------------------- flash ---
// out[b, i, h] = softmax_j(scale * q[b, i, h] . k[b, j, h / rep]) v[b, j, ...]
// over the keys j that the masks keep: j < Sk, j <= i (causal) and
// j > i - window (sliding window).  q [B, Sq, H, hd], k/v [B, Sk, KV, hd].
//
// Bound on the H100: at the prefill shapes (Sq = Sk up to ~1k, hd 64) the
// work is ~Sq^2 H hd operations against ~(Sq H + 2 Sk KV) hd bytes, so the
// bound is operations.  This first port computes in SIMT fp32 (the fp32
// tests hold it to 2e-5, which tensor-core bf16/TF32 inputs would not meet),
// so in practice it is bound by shared-memory traffic feeding the FMAs.
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
  const T* qb = q + static_cast<int64_t>(b) * Sq * q_row + h * HD;
  const T* kb_ = k + static_cast<int64_t>(b) * Sk * kv_row + kvh * HD;
  const T* vb = v + static_cast<int64_t>(b) * Sk * kv_row + kvh * HD;

  load_tiles<T, HD, kBQ, kFlashThreads>(qb + q0 * q_row, nullptr, q_row,
                                        Sq - q0, kBQ, scale, qs, QS, nullptr,
                                        0);

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
                                          vs, HD);
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
    T* o = out + static_cast<int64_t>(b) * Sq * q_row + qpos * q_row +
           h * HD;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int d = 4 * (cg + 4 * j);
      o[d] = from_f32<T>(acc[j].x / den);
      o[d + 1] = from_f32<T>(acc[j].y / den);
      o[d + 2] = from_f32<T>(acc[j].z / den);
      o[d + 3] = from_f32<T>(acc[j].w / den);
    }
  }
}

// ---------------------------------------------------------------- decode ---
// out[b, h] = softmax_j(scale * q[b, h] . kc[b, j, g]) vc[b, j, g] over the
// cached slots j <= pos[b] (j < min(pos[b] + 1, S)), g = h / rep.
// q [B, H, hd], caches [B, S, KV, hd], pos [B] int32.
//
// Bound on the H100: bytes.  One decode step reads each valid cache row
// once (2 x n_valid x KV x hd elements per batch row) and does ~4 operations
// per element read for each of the rep query heads that share it, far below
// the ~295 operations per byte where the card turns compute-bound.
// Design: the rep query heads of one KV head ride together in one block
// (scores [rep, tile] from one shared-memory copy of the key tile), so the
// cache is read once, not rep times.  At the serving shapes (B <= 4, KV = 2)
// one block per (b, kv-head) would fill 8 of 132 SMs, so the S sweep is
// split (flash-decoding): grid (n_split, KV, B), each block sweeps one
// chunk of slots in 64-slot tiles, keeping m / l in shared memory and its
// share of the [rep, hd] accumulator in registers; blocks whose chunk lies
// beyond pos[b] load nothing.  With one split the block writes the output;
// with more it writes fp32 partials (m, l, acc) and decode_combine_kernel
// rescales and sums them.  Slots beyond pos[b] are never read, and pos is
// read on the device, so a step costs no host round trip.
constexpr int kDecThreads = 128;
constexpr int kDecTile = 64;
constexpr int kMaxRep = 16;

template <int HD>
constexpr int decode_smem_floats(int rep) {
  return rep * (HD + 4) + kDecTile * (HD + 4) + kDecTile * HD +
         rep * (kDecTile + 1) + 3 * rep;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kDecThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ pos,
              T* __restrict__ out, float* __restrict__ part_ml,
              float* __restrict__ part_acc, int S, int KV, int rep,
              int chunk, float scale) {
  extern __shared__ float4 smem4[];
  constexpr int QS = HD + 4;
  float* qs = reinterpret_cast<float*>(smem4);   // [rep][QS]
  float* ks = qs + rep * QS;                     // [kDecTile][QS]
  float* vs = ks + kDecTile * QS;                // [kDecTile][HD]
  float* ps = vs + kDecTile * HD;                // [rep][kDecTile + 1]
  float* ms = ps + rep * (kDecTile + 1);         // [rep] running max
  float* ls = ms + rep;                          // [rep] running sum
  float* cs = ls + rep;                          // [rep] this tile's rescale

  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int H = KV * rep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_valid = max(0, min(pos[b] + 1, S));
  const int k_begin = split * chunk;
  const int k_end = min(k_begin + chunk, n_valid);
  const int64_t row = static_cast<int64_t>(KV) * HD;
  const T* kb_ = kc + static_cast<int64_t>(b) * S * row + g * HD;
  const T* vb = vc + static_cast<int64_t>(b) * S * row + g * HD;

  load_tiles<T, HD, kMaxRep, kDecThreads>(
      q + (static_cast<int64_t>(b) * H + g * rep) * HD, nullptr, HD, rep,
      rep, scale, qs, QS, nullptr, 0);
  if (tid < rep) {
    ms[tid] = kNegInf;
    ls[tid] = 0.f;
  }

  constexpr int NO = (kMaxRep * HD + kDecThreads - 1) / kDecThreads;
  float acc[NO];
#pragma unroll
  for (int j = 0; j < NO; ++j) acc[j] = 0.f;

  for (int kb = k_begin; kb < k_end; kb += kDecTile) {
    __syncthreads();                     // last tile's reads (and q) done
    load_tiles<T, HD, kDecTile, kDecThreads>(kb_ + kb * row, vb + kb * row,
                                             row, k_end - kb, kDecTile, 1.f,
                                             ks, QS, vs, HD);
    __syncthreads();
    for (int i = tid; i < rep * kDecTile; i += kDecThreads) {
      const int r = i / kDecTile, c = i % kDecTile;
      float s = kNegInf;
      if (kb + c < k_end) {
        const float4* a = reinterpret_cast<const float4*>(qs + r * QS);
        const float4* kk = reinterpret_cast<const float4*>(ks + c * QS);
        s = 0.f;
#pragma unroll 4
        for (int d4 = 0; d4 < HD / 4; ++d4) s = dot4(a[d4], kk[d4], s);
      }
      ps[r * (kDecTile + 1) + c] = s;
    }
    __syncthreads();
    for (int r = warp; r < rep; r += kDecThreads / 32) {
      float* pr = ps + r * (kDecTile + 1);
      const float s0 = pr[lane], s1 = pr[lane + 32];
      float mt = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, mt);
      const float p0 = s0 == kNegInf ? 0.f : expf(s0 - m_new);
      const float p1 = s1 == kNegInf ? 0.f : expf(s1 - m_new);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        ls[r] = ls[r] * corr + sum;
        ms[r] = m_new;
        cs[r] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int o = tid + j * kDecThreads;
      const int r = o / HD, d = o % HD;
      if (r < rep) {
        const float* pr = ps + r * (kDecTile + 1);
        float a = acc[j] * cs[r];
        for (int c = 0; c < kDecTile; ++c) a = fmaf(pr[c], vs[c * HD + d], a);
        acc[j] = a;
      }
    }
  }
  __syncthreads();                       // ms / ls final for every head

#pragma unroll
  for (int j = 0; j < NO; ++j) {
    const int o = tid + j * kDecThreads;
    const int r = o / HD, d = o % HD;
    if (r >= rep) continue;
    if (n_split == 1) {
      out[(static_cast<int64_t>(b) * H + g * rep + r) * HD + d] =
          from_f32<T>(acc[j] / fmaxf(ls[r], 1e-30f));
    } else {
      const int64_t part =
          ((static_cast<int64_t>(b) * KV + g) * n_split + split) * rep + r;
      part_acc[part * HD + d] = acc[j];
      if (d == 0) {
        part_ml[2 * part] = ms[r];
        part_ml[2 * part + 1] = ls[r];
      }
    }
  }
}

// The second pass of a split decode: for each (b, head), rescale every
// split's partial sum to the global max and divide by the global
// denominator.  One block per (b, head), one thread per output column; the
// split maxima and their weights exp(m_s - M) go through shared memory, so
// the per-split loads are independent and can all be in flight together.
constexpr int kMaxSplit = 512;

template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_ml,
                                      const float* __restrict__ part_acc,
                                      T* __restrict__ out, int KV, int rep,
                                      int n_split, int hd) {
  __shared__ float w[kMaxSplit];
  __shared__ float red[32];
  const int bh = blockIdx.x, d = threadIdx.x;
  const int H = KV * rep;
  const int b = bh / H, h = bh % H, g = h / rep, r = h % rep;
  const int64_t base =
      (static_cast<int64_t>(b) * KV + g) * n_split * rep + r;
  float m = kNegInf;
  for (int s = d; s < n_split; s += blockDim.x) {
    w[s] = part_ml[2 * (base + static_cast<int64_t>(s) * rep)];
    m = fmaxf(m, w[s]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((d & 31) == 0) red[d >> 5] = m;
  __syncthreads();
  m = red[0];
  for (int i = 1; i < (blockDim.x + 31) / 32; ++i) m = fmaxf(m, red[i]);
  for (int s = d; s < n_split; s += blockDim.x) w[s] = expf(w[s] - m);
  __syncthreads();
  float l = 0.f, a = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) {
    const int64_t part = base + static_cast<int64_t>(s) * rep;
    l = fmaf(part_ml[2 * part + 1], w[s], l);
    a = fmaf(part_acc[part * hd + d], w[s], a);
  }
  out[static_cast<int64_t>(bh) * hd + d] = from_f32<T>(a / fmaxf(l, 1e-30f));
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

template <typename T, int HD>
cudaError_t launch_decode(const void* q, const void* kc, const void* vc,
                          const void* pos, void* out, void* part_ml,
                          void* part_acc, int B, int S, int H, int KV,
                          int n_split, int chunk, float scale,
                          cudaStream_t st) {
  const int rep = H / KV;
  const int smem = decode_smem_floats<HD>(rep) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      decode_smem_floats<HD>(kMaxRep) * sizeof(float));
  if (err != cudaSuccess) return err;
  dim3 grid(n_split, KV, B);
  decode_kernel<T, HD><<<grid, kDecThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kc),
      static_cast<const T*>(vc), static_cast<const int*>(pos),
      static_cast<T*>(out), static_cast<float*>(part_ml),
      static_cast<float*>(part_acc), S, KV, rep, chunk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  decode_combine_kernel<T><<<B * H, HD, 0, st>>>(
      static_cast<const float*>(part_ml), static_cast<const float*>(part_acc),
      static_cast<T*>(out), KV, rep, n_split, HD);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, Sq, H, hd], k/v [B, Sk, KV, hd] -> out [B, Sq, H, hd]; hd in
// {32, 64, 128}, H a multiple of KV.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int B, int Sq, int Sk, int H, int KV,
                          int hd, int causal, int window, float scale,
                          int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH(T, HD)                                                  \
  return launch_flash<T, HD>(q, k, v, out, B, Sq, Sk, H, KV, causal, window, \
                             scale, st)
  if (dtype == 0) {
    if (hd == 32) REPRO_FLASH(float, 32);
    if (hd == 64) REPRO_FLASH(float, 64);
    if (hd == 128) REPRO_FLASH(float, 128);
  } else {
    if (hd == 32) REPRO_FLASH(__nv_bfloat16, 32);
    if (hd == 64) REPRO_FLASH(__nv_bfloat16, 64);
    if (hd == 128) REPRO_FLASH(__nv_bfloat16, 128);
  }
#undef REPRO_FLASH
  return static_cast<int>(cudaErrorInvalidValue);
}

// q [B, H, hd], caches [B, S, KV, hd], pos [B] int32 -> out [B, H, hd];
// part_ml [B, KV, n_split, rep, 2] and part_acc [B, KV, n_split, rep, hd]
// fp32 scratch when n_split > 1 (unused, may be null, when it is 1).
int repro_decode_attention(const void* q, const void* kc, const void* vc,
                           const void* pos, void* out, void* part_ml,
                           void* part_acc, int B, int S, int H, int KV,
                           int hd, int n_split, int chunk, float scale,
                           int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % KV != 0 || H / KV > kMaxRep || n_split > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_DECODE(T, HD)                                              \
  return launch_decode<T, HD>(q, kc, vc, pos, out, part_ml, part_acc, B, S, \
                              H, KV, n_split, chunk, scale, st)
  if (dtype == 0) {
    if (hd == 32) REPRO_DECODE(float, 32);
    if (hd == 64) REPRO_DECODE(float, 64);
    if (hd == 128) REPRO_DECODE(float, 128);
  } else {
    if (hd == 32) REPRO_DECODE(__nv_bfloat16, 32);
    if (hd == 64) REPRO_DECODE(__nv_bfloat16, 64);
    if (hd == 128) REPRO_DECODE(__nv_bfloat16, 128);
  }
#undef REPRO_DECODE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
