// v3 (design 3): c and 1 / c by value (2k words), selected by the missing
// index byte sel[g], a warp per group, a runtime-k loop.
#include "common.cuh"
__global__ void __launch_bounds__(256) mg_v3(const float* __restrict__ p, const float* __restrict__ o, float* __restrict__ out, const __grid_constant__ MgParams cf, int G, int k, int64_t n) {
  const int g = blockIdx.y * (blockDim.x / 32) + threadIdx.x / 32;
  if (g >= G) return;
  const int j = cf.sel[g];
  float inv = 0.f;
#pragma unroll 4
  for (int m = 0; m < k; ++m) inv = m == j ? cf.table[k + m] : inv;
  const float* pg = p + g * n; const float* og = o + (int64_t)g * k * n; float* outg = out + g * n;
  for (int64_t x = blockIdx.x * 32 + threadIdx.x % 32; x < n; x += (int64_t)gridDim.x * 32) {
    float acc = pg[x];
#pragma unroll 4
    for (int i = 0; i < k; ++i) { const float c = cf.table[i]; acc -= og[i * n + x] * (i == j ? 0.f : c); }
    outg[x] = acc * inv;
  }
}
extern "C" int probe_mg(const void* p, const void* o, const float* words, const uint8_t* sel, void* out, int G, int k, long long n, void* s) {
  MgParams cf; memcpy(cf.table, words, sizeof(float) * 2 * k); memcpy(cf.sel, sel, G);
  LAUNCH_GRID
  mg_v3<<<grid, warps * 32, 0, (cudaStream_t)s>>>((const float*)p, (const float*)o, (float*)out, cf, G, k, n);
  return (int)cudaGetLastError();
}
