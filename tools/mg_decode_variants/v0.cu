// v0: the kernel of PRs 11-21: a [G, k + 1] fp32 row array in device
// memory, one thread per element, a 64-bit division by n per element, the
// row read through __ldg in a runtime-k loop.
#include "common.cuh"
__global__ void __launch_bounds__(256) mg_v0(const float* __restrict__ p, const float* __restrict__ o, const float* __restrict__ cmat, float* __restrict__ out, int k, int64_t n, int64_t total) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
    const int64_t g = e / n; const int64_t x = e - g * n;
    const float* cg = cmat + g * (k + 1); const float* og = o + g * k * n + x;
    float acc = p[e];
    for (int i = 0; i < k; ++i) acc -= og[i * n] * __ldg(cg + i);
    out[e] = acc * __ldg(cg + k);
  }
}
extern "C" int probe_mg0(const void* p, const void* o, const void* cmat, void* out, int G, int k, long long n, void* s) {
  const long long total = (long long)G * n; int64_t b = (total + 255) / 256; if (b > kMaxBlocks) b = kMaxBlocks;
  mg_v0<<<(int)b, 256, 0, (cudaStream_t)s>>>((const float*)p, (const float*)o, (const float*)cmat, (float*)out, k, n, total);
  return (int)cudaGetLastError();
}
