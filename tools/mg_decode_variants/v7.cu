// v7 (design 4, the one shipped): v3 with k a template parameter, so a
// warp issues sel[g], the coefficients, P and the member loads before its
// first multiply-add.
#include "common.cuh"
template <int K>
__global__ void __launch_bounds__(256) mg_v7(const float* __restrict__ p, const float* __restrict__ o, float* __restrict__ out, const __grid_constant__ MgParams cf, int G, int64_t n) {
  const int g = blockIdx.y * (blockDim.x / 32) + threadIdx.x / 32;
  if (g >= G) return;
  const int j = cf.sel[g];
  float c[K], inv = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) { c[i] = i == j ? 0.f : cf.table[i]; inv = i == j ? cf.table[K + i] : inv; }
  const float* pg = p + g * n; const float* og = o + (int64_t)g * K * n; float* outg = out + g * n;
  for (int64_t x = blockIdx.x * 32 + threadIdx.x % 32; x < n; x += (int64_t)gridDim.x * 32) {
    float v[K];
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] = og[i * n + x];
    float acc = pg[x];
#pragma unroll
    for (int i = 0; i < K; ++i) acc -= v[i] * c[i];
    outg[x] = acc * inv;
  }
}
extern "C" int probe_mg(const void* p, const void* o, const float* words, const uint8_t* sel, void* out, int G, int k, long long n, void* s) {
  MgParams cf; memcpy(cf.table, words, sizeof(float) * 2 * k); memcpy(cf.sel, sel, G);
  LAUNCH_GRID
  if (k != 2) return 1;
  mg_v7<2><<<grid, warps * 32, 0, (cudaStream_t)s>>>((const float*)p, (const float*)o, (float*)out, cf, G, n);
  return (int)cudaGetLastError();
}
