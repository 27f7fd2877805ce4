// Shared by the B4 decode variants: the 2 KB parameter block of designs 2-4
// (kernels/multigroup_decode.py), the empty kernel, the warp-per-group grid.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>
constexpr int64_t kMaxBlocks = 132 * 16;
constexpr int kMgWarps = 8;
constexpr int kMgTableFloats = 256;
constexpr int kMgGroups = 1024;
struct MgParams { float table[kMgTableFloats]; uint8_t sel[kMgGroups]; };
__global__ void empty_kernel() {}
extern "C" int probe_empty(void* s) { empty_kernel<<<1, 32, 0, (cudaStream_t)s>>>(); return (int)cudaGetLastError(); }
#define LAUNCH_GRID \
  const int warps = G < kMgWarps ? G : kMgWarps; \
  const int64_t gy = (G + warps - 1) / warps; \
  int64_t gx = (n + 31) / 32; \
  dim3 grid((unsigned)gx, (unsigned)gy);
