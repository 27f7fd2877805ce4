// v2 (design 2): k rows of k + 1 words by value (row j: c with 0 at j and
// 1 / c_j), a warp per group reading row sel[g], a runtime-k loop.
#include "common.cuh"
__global__ void __launch_bounds__(256) mg_v2(const float* __restrict__ p, const float* __restrict__ o, float* __restrict__ out, const __grid_constant__ MgParams cf, int G, int k, int64_t n) {
  const int g = blockIdx.y * (blockDim.x / 32) + threadIdx.x / 32;
  if (g >= G) return;
  const int base = cf.sel[g] * (k + 1);
  const float* pg = p + g * n; const float* og = o + (int64_t)g * k * n; float* outg = out + g * n;
  const float inv = cf.table[base + k];
  for (int64_t x = blockIdx.x * 32 + threadIdx.x % 32; x < n; x += (int64_t)gridDim.x * 32) {
    float acc = pg[x];
#pragma unroll 4
    for (int i = 0; i < k; ++i) acc -= og[i * n + x] * cf.table[base + i];
    outg[x] = acc * inv;
  }
}
extern "C" int probe_mg(const void* p, const void* o, const float* words, const uint8_t* sel, void* out, int G, int k, long long n, void* s) {
  MgParams cf;
  for (int j = 0; j < k; ++j) { for (int i = 0; i < k; ++i) cf.table[j * (k + 1) + i] = i == j ? 0.f : words[i]; cf.table[j * (k + 1) + k] = words[k + j]; }
  memcpy(cf.sel, sel, G);
  LAUNCH_GRID
  mg_v2<<<grid, warps * 32, 0, (cudaStream_t)s>>>((const float*)p, (const float*)o, (float*)out, cf, G, k, n);
  return (int)cudaGetLastError();
}
