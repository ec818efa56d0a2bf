// Block-layout multiresolution hash-grid encode, forward only, for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// nerfstudio_torch/ops/hash_grid.py.
//
// Replaces, in the JAX reference package:
//   * K1 fwd: nerfstudio_tpu/ops/hash_grid.py block_level_geometry +
//     _row_gather_block_tw (hash_encode(block=True)): one stochastically
//     rounded 2x2x2 vertex block per (sample, level).
//   * K3: nerfstudio_tpu/ops/hash_grid.py _block_exact_trilerp
//     (hash_encode(block_exact=True)): the exact 8-corner trilinear
//     interpolation through the same block layout.
//
// Table layout, shared with the reference: table[l, row, lane], shape
// (L, S, 128) float32. Vertex v of level l lives in block b = v >> 1 (per
// axis); the block index is dense ((bx*bs + by)*bs + bz) when the level's
// bs^3 blocks fit the table (bs^3 * 8 <= T), hashed otherwise. Block b is
// stored at row b / bpr, lanes (b % bpr)*8F + corner*F + f, where
// bpr = 16 / F blocks share one 128-lane row and corner is the vertex's
// parity bits (px<<2 | py<<1 | pz).
//
// What bounds it: random gathers. One (sample, level) reads at most eight
// F-float groups; at F=4 a K3 stencil touches at most eight 128-byte lines
// (one per corner block) and a K1 stencil exactly one 8F-float block. The
// arithmetic is a few dozen flops per gather, so the kernel is bound by the
// latency and the sector count of its loads, not by flops. The design keeps
// it simple: one thread per (sample, level), level fastest, so the threads
// of a warp share the sample's position loads and write one contiguous run
// of output columns; table reads go through the read-only cache (__ldg).
// Making the gathers coalesce across samples is work for a later change.
//
// Bit-exactness with the reference: the stochastic odd-axis choice hashes
// the float bits of the cell offset o = clip(x*res - floor(x*res), 0, 1), so
// x*res and the subtraction must round exactly as the reference does. They
// are computed with __fmul_rn/__fsub_rn (never contracted into an FMA), and
// the library is also built with -fmad=false. Table values are rounded to
// bf16 (round to nearest even) before weighting; sums stay float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kLanes = 128;
constexpr int kThreads = 256;

struct LevelGeometry {
  int num_levels;
  int res[kMaxLevels];
  int blocks_per_axis[kMaxLevels];
  int dense[kMaxLevels];
};

// Per-axis prime pairs of the odd-axis coin (hash_grid.py block_level_geometry).
__constant__ uint32_t kCoinPrimes[3][2] = {
    {0x85EBCA6Bu, 0x9E3779B1u},
    {0xC2B2AE35u, 0x27D4EB2Fu},
    {0x165667B1u, 0xD3A2646Cu},
};

__device__ __forceinline__ float u01_hash(float o, uint32_t p1, uint32_t p2) {
  const uint32_t b = __float_as_uint(o);
  const uint32_t h = (b * p1) ^ ((b >> 7) * p2);
  return __fmul_rn(__uint2float_rn(h >> 8), 1.0f / 16777216.0f);
}

__device__ __forceinline__ uint32_t block_index(int bx, int by, int bz, int bs,
                                                int dense, uint32_t nblocks) {
  if (dense) return (uint32_t)((bx * bs + by) * bs + bz);
  const uint32_t h = ((uint32_t)bx * 1u) ^ ((uint32_t)by * 2654435761u) ^
                     ((uint32_t)bz * 805459861u);
  return h % nblocks;
}

// Base cell clipped to [0, res-1] and the offset inside it clipped to [0, 1].
__device__ __forceinline__ void axis_cell(float p, int res, int* i0, float* o) {
  const float s = __fmul_rn(p, (float)res);
  int i = (int)floorf(s);
  i = min(max(i, 0), res - 1);
  *i0 = i;
  *o = fminf(fmaxf(__fsub_rn(s, (float)i), 0.0f), 1.0f);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int F, bool kExact>
__global__ void __launch_bounds__(kThreads)
    block_encode_kernel(const float* __restrict__ pos,
                        const float* __restrict__ table,
                        float* __restrict__ out, int64_t n,
                        int64_t rows_per_level, uint32_t nblocks,
                        LevelGeometry g) {
  constexpr int kBlocksPerRow = kLanes / (8 * F);
  const int num_levels = g.num_levels;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * num_levels) return;
  const int64_t i = t / num_levels;
  const int l = (int)(t - i * num_levels);
  const int res = g.res[l];
  const int bs = g.blocks_per_axis[l];
  const int dense = g.dense[l];

  int i0[3];
  float o[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) axis_cell(__ldg(pos + 3 * i + a), res, &i0[a], &o[a]);

  const float* level_table = table + (int64_t)l * rows_per_level * kLanes;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;

  if (kExact) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int d[3] = {(c >> 2) & 1, (c >> 1) & 1, c & 1};
      int v[3];
      float w = 1.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        v[a] = i0[a] + d[a];
        const float wa = d[a] ? o[a] : __fsub_rn(1.0f, o[a]);
        w = a == 0 ? wa : __fmul_rn(w, wa);
      }
      const uint32_t blk = block_index(v[0] >> 1, v[1] >> 1, v[2] >> 1, bs, dense, nblocks);
      const int parity = ((v[0] & 1) << 2) | ((v[1] & 1) << 1) | (v[2] & 1);
      const float* src = level_table + (int64_t)(blk / kBlocksPerRow) * kLanes +
                         (blk % kBlocksPerRow) * 8 * F + parity * F;
#pragma unroll
      for (int f = 0; f < F; ++f)
        acc[f] = __fadd_rn(acc[f], __fmul_rn(w, bf16_round(__ldg(src + f))));
    }
  } else {
    // Stochastic odd-axis rounding: an even base cell's stencil lies in one
    // block; on an odd axis the block of the chosen vertex (up with
    // probability o) is read and all of that axis' weight goes to it.
    int bc[3];
    float w01[3][2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const bool odd = (i0[a] & 1) == 1;
      const bool up = u01_hash(o[a], kCoinPrimes[a][0], kCoinPrimes[a][1]) < o[a];
      bc[a] = (i0[a] + ((odd && up) ? 1 : 0)) >> 1;
      const float upf = up ? 1.0f : 0.0f;
      w01[a][0] = odd ? upf : __fsub_rn(1.0f, o[a]);
      w01[a][1] = odd ? __fsub_rn(1.0f, upf) : o[a];
    }
    const uint32_t blk = block_index(bc[0], bc[1], bc[2], bs, dense, nblocks);
    const float* src = level_table + (int64_t)(blk / kBlocksPerRow) * kLanes +
                       (blk % kBlocksPerRow) * 8 * F;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float w = __fmul_rn(__fmul_rn(w01[0][(c >> 2) & 1], w01[1][(c >> 1) & 1]),
                                w01[2][c & 1]);
#pragma unroll
      for (int f = 0; f < F; ++f)
        acc[f] = __fadd_rn(acc[f], __fmul_rn(w, bf16_round(__ldg(src + c * F + f))));
    }
  }

  float* dst = out + i * (int64_t)num_levels * F + (int64_t)l * F;
#pragma unroll
  for (int f = 0; f < F; ++f) dst[f] = acc[f];
}

template <bool kExact>
cudaError_t launch(int features_per_level, const float* pos, const float* table,
                   float* out, int64_t n, int64_t rows_per_level, uint32_t nblocks,
                   const LevelGeometry& g, cudaStream_t stream) {
  const int64_t work = n * g.num_levels;
  const unsigned int grid = (unsigned int)((work + kThreads - 1) / kThreads);
  switch (features_per_level) {
    case 1:
      block_encode_kernel<1, kExact><<<grid, kThreads, 0, stream>>>(pos, table, out, n, rows_per_level, nblocks, g);
      break;
    case 2:
      block_encode_kernel<2, kExact><<<grid, kThreads, 0, stream>>>(pos, table, out, n, rows_per_level, nblocks, g);
      break;
    case 4:
      block_encode_kernel<4, kExact><<<grid, kThreads, 0, stream>>>(pos, table, out, n, rows_per_level, nblocks, g);
      break;
    case 8:
      block_encode_kernel<8, kExact><<<grid, kThreads, 0, stream>>>(pos, table, out, n, rows_per_level, nblocks, g);
      break;
    case 16:
      block_encode_kernel<16, kExact><<<grid, kThreads, 0, stream>>>(pos, table, out, n, rows_per_level, nblocks, g);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// pos (n, 3) f32, table (num_levels, rows_per_level, 128) f32 and out
// (n, num_levels * features_per_level) f32 are contiguous device pointers;
// resolutions is a host array of num_levels ints. exact = 1 selects K3,
// 0 selects K1. Returns a cudaError_t (0 on success).
int nst_hash_encode_block(const void* pos, const void* table, void* out,
                          long long n, int num_levels, int features_per_level,
                          long long rows_per_level, long long hash_table_size,
                          const int* resolutions, int exact, void* stream) {
  if (num_levels < 1 || num_levels > kMaxLevels || n < 0 || hash_table_size % 8 != 0 ||
      hash_table_size / 8 > 0xFFFFFFFFLL || rows_per_level < 1)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  LevelGeometry g;
  g.num_levels = num_levels;
  for (int l = 0; l < num_levels; ++l) {
    const long long res = resolutions[l];
    if (res < 1) return (int)cudaErrorInvalidValue;
    const long long bs = (res + 2) / 2;
    g.res[l] = (int)res;
    g.blocks_per_axis[l] = (int)bs;
    g.dense[l] = bs * bs * bs * 8 <= hash_table_size ? 1 : 0;
  }
  const uint32_t nblocks = (uint32_t)(hash_table_size / 8);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)pos;
  const float* tab = (const float*)table;
  float* o = (float*)out;
  const cudaError_t err =
      exact ? launch<true>(features_per_level, p, tab, o, n, rows_per_level, nblocks, g, s)
            : launch<false>(features_per_level, p, tab, o, n, rows_per_level, nblocks, g, s);
  return (int)err;
}

const char* nst_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
