// Multiresolution hash-grid encode, block and flat layouts, forward and
// backward, for Hopper (sm_90a). Plain C interface, loaded with ctypes by
// nerfstudio_torch/ops/hash_grid.py.
//
// Replaces, in the JAX reference package:
//   * K7 fwd and bwd: nerfstudio_tpu/ops/hash_grid.py hash_encode's flat
//     8-corner path (:991-1031) through _row_gather_select (:62-107) and
//     _hash_corner (:732): flat_encode_kernel, flat_encode_bwd_kernel below.
//   * K1 fwd: nerfstudio_tpu/ops/hash_grid.py block_level_geometry +
//     _row_gather_block_tw (hash_encode(block=True)): one stochastically
//     rounded 2x2x2 vertex block per (sample, level).
//   * K3: nerfstudio_tpu/ops/hash_grid.py _block_exact_trilerp
//     (hash_encode(block_exact=True)): the exact 8-corner trilinear
//     interpolation through the same block layout.
//   * K1 bwd with K2 folded in: nerfstudio_tpu/ops/hash_grid.py
//     _row_gather_block_tw_bwd, _row_gather_block_tw_oh_bwd (the one-hot
//     matmul backward of the dense coarse levels) and _grad_scale, plus
//     XLA's autodiff of block_level_geometry down to the positions.
//
// Table layout, shared with the reference: table[l, row, lane], shape
// (L, S, 128) float32. Vertex v of level l lives in block b = v >> 1 (per
// axis); the block index is dense ((bx*bs + by)*bs + bz) when the level's
// bs^3 blocks fit the table (bs^3 * 8 <= T), hashed otherwise. Block b is
// stored at row b / bpr, lanes (b % bpr)*8F + corner*F + f, where
// bpr = 16 / F blocks share one 128-lane row and corner is the vertex's
// parity bits (px<<2 | py<<1 | pz).
//
// Block b of a level is the 8F floats at level_table + b*8F: rows of 128
// lanes hold bpr whole blocks each, so the row/slot split is the block's
// offset divided by 128 and needs no arithmetic of its own. A block is
// 32F bytes, 32F-byte aligned (the level stride is a multiple of 512
// bytes): one 128-byte line at F=4, half of one at F=2.
//
// What bounds it: random gathers. One (sample, level) reads at most eight
// F-float groups; at F=4 a K3 stencil touches at most eight 128-byte lines
// (one per corner block) and a K1 stencil exactly one 8F-float block. The
// arithmetic is a few dozen flops per gather, so the kernels are bound by
// the latency and the request count of their loads, not by flops.
//
// Two designs of the forward:
//   * block_encode_kernel (the first design, "per-thread"): one thread per
//     (sample, level), level fastest, 8F scalar 4-byte loads per thread.
//     Each lane of a warp is another stencil, so one load instruction asks
//     L1 for up to 32 lines. Kept for F in {1, 8, 16}, which no shipped
//     config uses, and so that chip_smoke.py can time it beside the second
//     design; the package's paths take it only for those widths.
//   * block_stochastic_lanes_kernel (K1) and block_exact_lanes_kernel (K3),
//     the "lane groups" design, for F in {2, 4}. Each lane first computes
//     one stencil's geometry, as the first design does: its cells, K1's
//     odd-axis coins and block, K3's eight corner blocks (each axis's two
//     block coordinates and hash products once), and the eight weights. It
//     writes each corner's table offset and weight to a per-warp table in
//     shared memory. Then a group of lanes serves one stencil: K1's 2F lanes
//     read its block as 2F 16-byte vectors (one line at F=4), K3's 8 lanes
//     one corner each, its F floats as one 8- or 16-byte vector; corners of
//     one block are neighbouring pieces of one line. A warp's load
//     instruction covers 32/G stencils in a few lines, instead of 32
//     stencils in 32 lines, and one instruction loads what took F. Each lane
//     weights its values, the group sums them with a butterfly that halves
//     the values each lane holds (log2 F stages) and then adds, and F lanes
//     store one feature each, so a warp's store covers its stencils'
//     contiguous outputs. The geometry is computed once per stencil:
//     recomputed in every lane of a group it costs G times the
//     instructions (eight times for K3), and the kernel is then bound by
//     instruction issue, not by its loads. The shared table is
//     k-major with rows rotated so that neither its writes nor a round's
//     reads conflict in banks beyond two-way. A shuffle could not hand the
//     offsets over: it reads one register of the source lane, and each lane
//     of a group needs another corner's. The index math has no divide: the
//     hash's mod nblocks and the level split of the stencil index are a
//     mask and a shift for powers of two, else a multiply-high by a magic
//     number (hash_grid._u32_divisor), all in 32 bits. Levels run fastest
//     within the grid, so a warp's stencils are neighbouring levels of a few
//     samples and their outputs are contiguous. Running the levels along
//     blockIdx.y instead (a warp's stencils neighbouring samples of one
//     level) was slower on the H100 at both the check and the render inputs
//     (PERF.md).
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

// Per-level factor on the table gradient: bwd_scale on the levels of
// bwd_levels, 0 on the others, 1 everywhere without level subsampling.
struct LevelScales {
  float scale[kMaxLevels];
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

// Unsigned 32-bit division by a runtime divisor d with no divide
// instruction (hash_grid._u32_divisor): magic 0 marks a power of two,
// d = 2^shift; otherwise x / d = (t + ((x - t) >> 1)) >> (shift - 1), t =
// umulhi(x, magic), exact for every uint32 x.
struct U32Divisor {
  uint32_t d, magic, shift;
};

__device__ __forceinline__ uint32_t udiv(uint32_t x, const U32Divisor& v) {
  if (v.magic == 0) return x >> v.shift;
  const uint32_t t = __umulhi(x, v.magic);
  return (t + ((x - t) >> 1)) >> (v.shift - 1);
}

__device__ __forceinline__ uint32_t umod(uint32_t x, const U32Divisor& v) {
  return v.magic == 0 ? (x & (v.d - 1)) : x - udiv(x, v) * v.d;
}

// One halving stage of a group's butterfly: a lane holding N values keeps
// the upper half if its bit kOff is set (else the lower), sends the other
// half to the lane kOff away and adds what that lane sent.
template <int N, int kOff>
__device__ __forceinline__ void halve_stage(float* a, unsigned lane) {
  const bool upper = (lane & kOff) != 0;
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    const float send = upper ? a[k] : a[N / 2 + k];
    const float keep = upper ? a[N / 2 + k] : a[k];
    a[k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, kOff));
  }
}

// The sums of a[0..F-1] over each group of G consecutive lanes (F = 2 or
// 4, F <= G): log2 F halving stages, then adds. Lane r of a group returns
// the sum of value r / (G / F); 4 shuffles at F=4, G=8 against 12 for F
// full sums. Every lane of the warp takes part.
template <int G, int F>
__device__ __forceinline__ float group_sum_scatter(float (&a)[F], unsigned lane) {
  static_assert(F == 2 || F == 4, "two or four values per lane");
  halve_stage<F, G / 2>(a, lane);
  if constexpr (F == 4) halve_stage<2, G / 4>(a, lane);
  float s = a[0];
#pragma unroll
  for (int off = G / (2 * F); off >= 1; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
  return s;
}

// Round a float to bf16 (nearest even) and back, two at a time.
__device__ __forceinline__ void bf16_round2(float& x, float& y) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(x, y);
  x = __low2float(b);
  y = __high2float(b);
}

// The arguments of both lane kernels.
struct LaneArgs {
  const float* pos;
  const float* table;
  float* out;
  uint32_t n;
  uint32_t level_stride;  // floats; the whole table holds fewer than 2^32
  U32Divisor levels;      // d = the level count
  U32Divisor nblocks;     // d = T / 8
};

// Stencils of one warp: lane s of warp w owns stencil t = (block, w, s) of
// the grid, levels fastest: sample t / L, level t % L, output row t. Valid
// stencils are a prefix of the warp's lanes.
__device__ __forceinline__ bool stencil_of(const LaneArgs& a, uint32_t t, uint32_t* i, int* l) {
  *i = udiv(t, a.levels);
  *l = (int)(t - *i * a.levels.d);
  return *i < a.n;
}

// Slot of (group lane k, stencil s) in a warp's shared table: k-major, each
// row rotated by R*k, so that the lanes of one round (R stencils, G lanes
// each, R*G = 32) read 32 distinct slots mod 16 twice over, and the 32
// lanes writing one k write a rotation of one row.
template <int R>
__device__ __forceinline__ int slot(int k, int s) {
  return k * 32 + ((s + R * k) & 31);
}

// K3, lane groups. Phase 1: lane s computes its stencil's cells, its eight
// corners' table offsets and trilinear weights (each axis's two block
// coordinates and hash products once) and writes them to the warp's table.
// Phase 2: 8 rounds of 4 stencils; lane 8q + c reads corner c of stencil
// 4r + q as one F-float vector, weights it, and the 8 lanes of the stencil
// sum with group_sum_scatter.
template <int F>
__global__ void __launch_bounds__(kThreads)
    block_exact_lanes_kernel(LaneArgs a, LevelGeometry g) {
  constexpr int G = 8, R = 32 / G;
  __shared__ uint2 corners[kThreads / 32][8 * 32];  // (offset, weight bits)
  const unsigned lane = threadIdx.x & 31u;
  uint2* tab = corners[threadIdx.x >> 5];
  const uint32_t t0 = blockIdx.x * kThreads + (threadIdx.x & ~31u);
  uint32_t i;
  int l;
  const bool valid = stencil_of(a, t0 + lane, &i, &l);
  if (valid) {
    const int res = g.res[l];
    const uint32_t bs = (uint32_t)g.blocks_per_axis[l];
    const bool dense = g.dense[l] != 0;
    uint32_t bc[3][2], par[3][2];
    float w[3][2];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      int i0;
      float o;
      axis_cell(__ldg(a.pos + 3 * (int64_t)i + ax), res, &i0, &o);
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        bc[ax][d] = (uint32_t)(i0 + d) >> 1;
        par[ax][d] = (uint32_t)(i0 + d) & 1u;
      }
      w[ax][0] = __fsub_rn(1.0f, o);
      w[ax][1] = o;
    }
    if (!dense) {  // the hash's per-axis products
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        bc[1][d] *= 2654435761u;
        bc[2][d] *= 805459861u;
      }
    }
    const uint32_t base = (uint32_t)l * a.level_stride;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int dx = (c >> 2) & 1, dy = (c >> 1) & 1, dz = c & 1;
      const uint32_t blk = dense ? (bc[0][dx] * bs + bc[1][dy]) * bs + bc[2][dz]
                                 : umod(bc[0][dx] ^ bc[1][dy] ^ bc[2][dz], a.nblocks);
      const uint32_t parity = (par[0][dx] << 2) | (par[1][dy] << 1) | par[2][dz];
      const float wc = __fmul_rn(__fmul_rn(w[0][dx], w[1][dy]), w[2][dz]);
      tab[slot<R>(c, lane)] = make_uint2(base + blk * (8 * F) + parity * F, __float_as_uint(wc));
    }
  }
  const int count = __popc(__ballot_sync(0xffffffffu, valid));
  __syncwarp();
  const int c = lane & (G - 1), q = lane / G;
#pragma unroll 2
  for (int r = 0; r < 32 / R; ++r) {
    if (R * r >= count) break;  // the same for the whole warp
    const int s = R * r + q;
    const bool live = s < count;
    const uint2 e = tab[slot<R>(c, live ? s : 0)];
    const float wc = __uint_as_float(e.y);
    const float* src = a.table + (live ? e.x : 0u);
    float acc[F];
    if constexpr (F == 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src));
      acc[0] = v.x, acc[1] = v.y, acc[2] = v.z, acc[3] = v.w;
      bf16_round2(acc[2], acc[3]);
    } else {
      const float2 v = __ldg(reinterpret_cast<const float2*>(src));
      acc[0] = v.x, acc[1] = v.y;
    }
    bf16_round2(acc[0], acc[1]);
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = __fmul_rn(wc, acc[f]);
    const float sum = group_sum_scatter<G, F>(acc, lane);
    if (live && (c & (G / F - 1)) == 0) a.out[(int64_t)(t0 + s) * F + c / (G / F)] = sum;
  }
}

// K1, lane groups. Phase 1: lane s computes its stencil's cells, odd-axis
// coins, block offset and eight corner weights and writes them to the
// warp's table. Phase 2: 2F rounds of 32/(2F) stencils; lane 2Fq + k reads
// the k-th 16-byte vector of stencil R*r + q's block (its corners
// 4k/F .. 4k/F + 4/F - 1), weights it, and the 2F lanes sum.
template <int F>
__global__ void __launch_bounds__(kThreads)
    block_stochastic_lanes_kernel(LaneArgs a, LevelGeometry g) {
  constexpr int G = 2 * F, R = 32 / G, kCorners = 4 / F;
  __shared__ uint32_t offsets[kThreads / 32][32];
  __shared__ float weights[kThreads / 32][G * 32 * kCorners];
  const unsigned lane = threadIdx.x & 31u;
  const int warp = threadIdx.x >> 5;
  const uint32_t t0 = blockIdx.x * kThreads + (threadIdx.x & ~31u);
  uint32_t i;
  int l;
  const bool valid = stencil_of(a, t0 + lane, &i, &l);
  if (valid) {
    const int res = g.res[l];
    uint32_t bc[3];
    float w01[3][2];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      int i0;
      float o;
      axis_cell(__ldg(a.pos + 3 * (int64_t)i + ax), res, &i0, &o);
      const bool odd = (i0 & 1) == 1;
      const bool up = u01_hash(o, kCoinPrimes[ax][0], kCoinPrimes[ax][1]) < o;
      bc[ax] = (uint32_t)(i0 + ((odd && up) ? 1 : 0)) >> 1;
      const float upf = up ? 1.0f : 0.0f;
      w01[ax][0] = odd ? upf : __fsub_rn(1.0f, o);
      w01[ax][1] = odd ? __fsub_rn(1.0f, upf) : o;
    }
    const uint32_t blk = g.dense[l] ? (bc[0] * (uint32_t)g.blocks_per_axis[l] + bc[1]) *
                                              (uint32_t)g.blocks_per_axis[l] + bc[2]
                                        : umod(bc[0] ^ (bc[1] * 2654435761u) ^ (bc[2] * 805459861u), a.nblocks);
    offsets[warp][lane] = (uint32_t)l * a.level_stride + blk * (8 * F);
#pragma unroll
    for (int k = 0; k < G; ++k) {
#pragma unroll
      for (int m = 0; m < kCorners; ++m) {
        const int c = k * kCorners + m;
        weights[warp][slot<R>(k, lane) * kCorners + m] =
            __fmul_rn(__fmul_rn(w01[0][(c >> 2) & 1], w01[1][(c >> 1) & 1]), w01[2][c & 1]);
      }
    }
  }
  const int count = __popc(__ballot_sync(0xffffffffu, valid));
  __syncwarp();
  const int k = lane & (G - 1), q = lane / G;
#pragma unroll 2
  for (int r = 0; r < 32 / R; ++r) {
    if (R * r >= count) break;  // the same for the whole warp
    const int s = R * r + q;
    const bool live = s < count;
    const int sl = slot<R>(k, live ? s : 0) * kCorners;
    const float4 v = __ldg(reinterpret_cast<const float4*>(a.table + (live ? offsets[warp][s] : 0u)) + k);
    float vals[4] = {v.x, v.y, v.z, v.w};
    bf16_round2(vals[0], vals[1]);
    bf16_round2(vals[2], vals[3]);
    float acc[F];
#pragma unroll
    for (int m = 0; m < kCorners; ++m) {
      const float wc = weights[warp][sl + m];
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float term = __fmul_rn(wc, vals[m * F + f]);
        acc[f] = m == 0 ? term : __fadd_rn(acc[f], term);
      }
    }
    const float sum = group_sum_scatter<G, F>(acc, lane);
    if (live && (k & (G / F - 1)) == 0) a.out[(int64_t)(t0 + s) * F + k / (G / F)] = sum;
  }
}

// K1 backward. One thread per sample walks the levels in order, recomputing
// each level's cell, coin, block and corner weights with the forward's
// arithmetic, so it takes the blocks the forward read.
//
// Table gradient: lane (slot*8F + c*F + f) of row `rows` gets
// (w8[c] * g[l*F+f]) * scale[l] by an f32 atomicAdd into a zeroed buffer.
// A level of scale 0 (outside bwd_levels) writes nothing, and neither does
// a corner of weight 0 (the unchosen parity of an odd axis). The dense
// coarse levels, which the reference sends through a bf16 one-hot matmul
// (K2), take the same f32 atomics: that rounding was an operand format of
// the TPU's matrix unit, not part of the op.
//
// Position gradient (d_pos != nullptr): d_w8[c] = sum_f g[l*F+f] *
// bf16(table value) on every level; an even axis carries
// d_o = sum_c d_w8[c] * (+-1) * (the other two axes' weights), an odd axis
// (its weights are the coin's 0/1) carries none, and d_x = d_o * res *
// clip'(x*res - i0), where clip' is 1 inside (0, 1), 0 outside and 1/2 on
// exactly 0 or 1, as jnp.clip's max/min pair differentiates.
//
// What bounds it: the atomics and the gathered rows. A (sample, level)
// issues at most 8F atomics into one 8F-float block (on average 3.4 of the
// 8 corners have weight) and, for the position gradient, re-reads that
// block; the coarse levels concentrate all samples' atomics on a few
// hundred rows. Privatising those rows in shared memory, sorting by row and
// warp-aggregating the atomics are later work.
template <int F>
__global__ void __launch_bounds__(kThreads)
    block_encode_bwd_kernel(const float* __restrict__ pos,
                            const float* __restrict__ table,
                            const float* __restrict__ grad,
                            float* __restrict__ d_table,
                            float* __restrict__ d_pos, int64_t n,
                            int64_t rows_per_level, uint32_t nblocks,
                            LevelGeometry g, LevelScales sc) {
  constexpr int kBlocksPerRow = kLanes / (8 * F);
  const int num_levels = g.num_levels;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool need_pos = d_pos != nullptr;
  float p[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) p[a] = __ldg(pos + 3 * i + a);
  float dp[3] = {0.0f, 0.0f, 0.0f};

  for (int l = 0; l < num_levels; ++l) {
    const float scale = d_table != nullptr ? sc.scale[l] : 0.0f;
    if (scale == 0.0f && !need_pos) continue;
    const int res = g.res[l];
    int i0[3];
    float o[3], dodx[3];
    bool odd[3];
    float w01[3][2];
    int bc[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float s = __fmul_rn(p[a], (float)res);
      int c = (int)floorf(s);
      c = min(max(c, 0), res - 1);
      i0[a] = c;
      const float t = __fsub_rn(s, (float)c);
      o[a] = fminf(fmaxf(t, 0.0f), 1.0f);
      dodx[a] = (t > 0.0f && t < 1.0f) ? (float)res
                : (t == 0.0f || t == 1.0f) ? 0.5f * (float)res
                                           : 0.0f;
      odd[a] = (c & 1) == 1;
      const bool up = u01_hash(o[a], kCoinPrimes[a][0], kCoinPrimes[a][1]) < o[a];
      bc[a] = (c + ((odd[a] && up) ? 1 : 0)) >> 1;
      const float upf = up ? 1.0f : 0.0f;
      w01[a][0] = odd[a] ? upf : __fsub_rn(1.0f, o[a]);
      w01[a][1] = odd[a] ? __fsub_rn(1.0f, upf) : o[a];
    }
    const uint32_t blk = block_index(bc[0], bc[1], bc[2], g.blocks_per_axis[l], g.dense[l], nblocks);
    const int64_t off = (int64_t)l * rows_per_level * kLanes + (int64_t)(blk / kBlocksPerRow) * kLanes +
                        (blk % kBlocksPerRow) * 8 * F;
    float gl[F];
#pragma unroll
    for (int f = 0; f < F; ++f) gl[f] = __ldg(grad + i * (int64_t)num_levels * F + (int64_t)l * F + f);

    if (scale != 0.0f) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float w = __fmul_rn(__fmul_rn(w01[0][(c >> 2) & 1], w01[1][(c >> 1) & 1]), w01[2][c & 1]);
        if (w == 0.0f) continue;
#pragma unroll
        for (int f = 0; f < F; ++f) atomicAdd(d_table + off + c * F + f, __fmul_rn(__fmul_rn(w, gl[f]), scale));
      }
    }
    if (need_pos) {
      float dw8[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int f = 0; f < F; ++f)
          acc = __fadd_rn(acc, __fmul_rn(gl[f], bf16_round(__ldg(table + off + c * F + f))));
        dw8[c] = acc;
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        if (odd[a] || dodx[a] == 0.0f) continue;
        const int b1 = a == 0 ? 1 : 0, b2 = a == 2 ? 1 : 2;  // the other two axes
        float d_o = 0.0f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int bit = (c >> (2 - a)) & 1;
          const float other = __fmul_rn(w01[b1][(c >> (2 - b1)) & 1], w01[b2][(c >> (2 - b2)) & 1]);
          const float term = __fmul_rn(dw8[c], other);
          d_o = bit ? __fadd_rn(d_o, term) : __fsub_rn(d_o, term);
        }
        dp[a] = __fadd_rn(dp[a], __fmul_rn(d_o, dodx[a]));
      }
    }
  }
  if (need_pos) {
#pragma unroll
    for (int a = 0; a < 3; ++a) d_pos[3 * i + a] = dp[a];
  }
}

// K7: the flat layout (hash_encode with neither block flag; neus-facto's
// proposal nets). Entry e of level l holds its F features at
// table[l] + e*F: the (S, 128) rows pack 128/F entries each, row-major, so
// no repacking is needed. A level is dense when (res+1)^3 <= T: corner
// coordinates are clipped to [0, res] and indexed (cx*side + cy)*side + cz;
// otherwise they are hashed (uint32 XOR of the coordinate-prime products,
// negative coordinates wrapping as the reference's astype(uint32)) mod T.
// Unlike the block layout nothing is clipped before the hash: the offset
// is x*res - floor(x*res), whose derivative is res everywhere.
struct FlatGeometry {
  int num_levels;
  int res[kMaxLevels];
  int dense[kMaxLevels];
};

__device__ __forceinline__ int64_t flat_entry(int cx, int cy, int cz, int res, int dense,
                                              uint32_t hash_table_size) {
  if (dense) {
    const int side = res + 1;
    cx = min(max(cx, 0), side - 1);
    cy = min(max(cy, 0), side - 1);
    cz = min(max(cz, 0), side - 1);
    return ((int64_t)cx * side + cy) * side + cz;
  }
  const uint32_t h = ((uint32_t)cx * 1u) ^ ((uint32_t)cy * 2654435761u) ^ ((uint32_t)cz * 805459861u);
  return (int64_t)(h % hash_table_size);
}

// Base vertex and offset of one axis: s = x*res rounded once, o = s - floor(s).
__device__ __forceinline__ void flat_axis(float p, int res, int* i0, float* o) {
  const float s = __fmul_rn(p, (float)res);
  const float fl = floorf(s);
  *i0 = (int)fl;
  *o = __fsub_rn(s, fl);
}

// K7 forward. One thread per (sample, level), level fastest, as K1. The
// eight corners are summed in the reference's order 0..7 of
// c = dx<<2 | dy<<1 | dz, each term w_c * bf16(value) with
// w_c = ((x-weight * y-weight) * z-weight), all rounded as the reference
// rounds them, so the output is bit-exact.
//
// What bounds it: eight random F-float gathers per (sample, level), each
// in its own 32-byte sector on the hashed levels (the dense coarse levels
// stay in L2), against a few dozen flops. Latency and sector count of the
// loads, not flops; the design is the simple one.
template <int F>
__global__ void __launch_bounds__(kThreads)
    flat_encode_kernel(const float* __restrict__ pos, const float* __restrict__ table,
                       float* __restrict__ out, int64_t n, int64_t level_stride,
                       uint32_t hash_table_size, FlatGeometry g) {
  const int num_levels = g.num_levels;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * num_levels) return;
  const int64_t i = t / num_levels;
  const int l = (int)(t - i * num_levels);
  const int res = g.res[l];
  int i0[3];
  float o[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) flat_axis(__ldg(pos + 3 * i + a), res, &i0[a], &o[a]);
  float w01[3][2];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    w01[a][0] = __fsub_rn(1.0f, o[a]);
    w01[a][1] = o[a];
  }
  const float* level_table = table + (int64_t)l * level_stride;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int dx = (c >> 2) & 1, dy = (c >> 1) & 1, dz = c & 1;
    const float w = __fmul_rn(__fmul_rn(w01[0][dx], w01[1][dy]), w01[2][dz]);
    const float* src = level_table + flat_entry(i0[0] + dx, i0[1] + dy, i0[2] + dz, res, g.dense[l],
                                                hash_table_size) * F;
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(w, bf16_round(__ldg(src + f))));
  }
  float* dst = out + i * (int64_t)num_levels * F + (int64_t)l * F;
#pragma unroll
  for (int f = 0; f < F; ++f) dst[f] = acc[f];
}

// K7 backward. One thread per sample walks the levels, recomputing each
// level's corners and weights with the forward's arithmetic.
//
// Table gradient (d_table != nullptr): entry e of corner c gets
// w_c * g[l*F+f] by an f32 atomicAdd into a zeroed buffer (the reference's
// unsorted row scatter-add, hash_grid.py _row_gather_select_bwd); f32 end
// to end, the bf16 rounding is the forward's read precision only. A corner
// of weight 0 writes nothing.
//
// Position gradient (d_pos != nullptr): d_w_c = sum_f g[l*F+f] *
// bf16(value), d_o[a] = sum_c d_w_c * (+1 if corner c is up on axis a else
// -1) * (the other two axes' weights), d_x[a] += res * d_o[a].
//
// What bounds it: 8F atomics per (sample, level) into random entries; on
// the dense coarse levels many samples hit the same few thousand entries,
// so those atomics contend. Privatising the coarse levels in shared memory
// is later work.
template <int F>
__global__ void __launch_bounds__(kThreads)
    flat_encode_bwd_kernel(const float* __restrict__ pos, const float* __restrict__ table,
                           const float* __restrict__ grad, float* __restrict__ d_table,
                           float* __restrict__ d_pos, int64_t n, int64_t level_stride,
                           uint32_t hash_table_size, FlatGeometry g) {
  const int num_levels = g.num_levels;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const bool need_pos = d_pos != nullptr;
  float p[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) p[a] = __ldg(pos + 3 * i + a);
  float dp[3] = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < num_levels; ++l) {
    const int res = g.res[l];
    int i0[3];
    float o[3], w01[3][2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      flat_axis(p[a], res, &i0[a], &o[a]);
      w01[a][0] = __fsub_rn(1.0f, o[a]);
      w01[a][1] = o[a];
    }
    float gl[F];
#pragma unroll
    for (int f = 0; f < F; ++f) gl[f] = __ldg(grad + i * (int64_t)num_levels * F + (int64_t)l * F + f);
    const int64_t level_off = (int64_t)l * level_stride;
    float dw8[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int dx = (c >> 2) & 1, dy = (c >> 1) & 1, dz = c & 1;
      const float w = __fmul_rn(__fmul_rn(w01[0][dx], w01[1][dy]), w01[2][dz]);
      const int64_t off = level_off + flat_entry(i0[0] + dx, i0[1] + dy, i0[2] + dz, res, g.dense[l],
                                                 hash_table_size) * F;
      if (d_table != nullptr && w != 0.0f) {
#pragma unroll
        for (int f = 0; f < F; ++f) atomicAdd(d_table + off + f, __fmul_rn(w, gl[f]));
      }
      if (need_pos) {
        float acc = 0.0f;
#pragma unroll
        for (int f = 0; f < F; ++f) acc = __fadd_rn(acc, __fmul_rn(gl[f], bf16_round(__ldg(table + off + f))));
        dw8[c] = acc;
      }
    }
    if (need_pos) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int b1 = a == 0 ? 1 : 0, b2 = a == 2 ? 1 : 2;  // the other two axes
        float d_o = 0.0f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int bit = (c >> (2 - a)) & 1;
          const float other = __fmul_rn(w01[b1][(c >> (2 - b1)) & 1], w01[b2][(c >> (2 - b2)) & 1]);
          const float term = __fmul_rn(dw8[c], other);
          d_o = bit ? __fadd_rn(d_o, term) : __fsub_rn(d_o, term);
        }
        dp[a] = __fadd_rn(dp[a], __fmul_rn(d_o, (float)res));
      }
    }
  }
  if (need_pos) {
#pragma unroll
    for (int a = 0; a < 3; ++a) d_pos[3 * i + a] = dp[a];
  }
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

// The lane-group kernel of K1 or K3 at F: one thread per stencil, levels
// fastest over the grid.
template <int F>
void launch_lanes(bool exact, const LaneArgs& a, cudaStream_t stream, const LevelGeometry& g) {
  const uint64_t stencils = (uint64_t)a.n * a.levels.d;
  const unsigned int grid = (unsigned int)((stencils + kThreads - 1) / kThreads);
  if (exact)
    block_exact_lanes_kernel<F><<<grid, kThreads, 0, stream>>>(a, g);
  else
    block_stochastic_lanes_kernel<F><<<grid, kThreads, 0, stream>>>(a, g);
}

// Validate the shared arguments and fill the per-level geometry.
cudaError_t make_geometry(long long n, int num_levels, long long rows_per_level,
                          long long hash_table_size, const int* resolutions,
                          LevelGeometry* g) {
  if (num_levels < 1 || num_levels > kMaxLevels || n < 0 || hash_table_size % 8 != 0 ||
      hash_table_size / 8 > 0xFFFFFFFFLL || rows_per_level < 1)
    return cudaErrorInvalidValue;
  g->num_levels = num_levels;
  for (int l = 0; l < num_levels; ++l) {
    const long long res = resolutions[l];
    if (res < 1) return cudaErrorInvalidValue;
    const long long bs = (res + 2) / 2;
    g->res[l] = (int)res;
    g->blocks_per_axis[l] = (int)bs;
    g->dense[l] = bs * bs * bs * 8 <= hash_table_size ? 1 : 0;
  }
  return cudaSuccess;
}

cudaError_t make_flat_geometry(long long n, int num_levels, long long rows_per_level,
                               long long hash_table_size, const int* resolutions, FlatGeometry* g) {
  if (num_levels < 1 || num_levels > kMaxLevels || n < 0 || hash_table_size < 1 ||
      hash_table_size > 0xFFFFFFFFLL || rows_per_level < 1)
    return cudaErrorInvalidValue;
  g->num_levels = num_levels;
  for (int l = 0; l < num_levels; ++l) {
    const long long res = resolutions[l];
    if (res < 1) return cudaErrorInvalidValue;
    g->res[l] = (int)res;
    g->dense[l] = (res + 1) * (res + 1) * (res + 1) <= hash_table_size ? 1 : 0;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// pos (n, 3) f32, table (num_levels, rows_per_level, 128) f32 and out
// (n, num_levels * features_per_level) f32 are contiguous device pointers;
// resolutions is a host array of num_levels ints. exact = 1 selects K3,
// 0 selects K1. design 0 takes block_encode_kernel (one thread per
// (sample, level)); 1 the lane groups. The lane groups take F = 2 or 4, a
// 16-byte aligned table of fewer than 2^32 floats, n * num_levels < 2^31,
// and the divisors (magic, shift) of the level count and of T/8 from
// hash_grid._u32_divisor. Returns a cudaError_t (0 on success).
int nst_hash_encode_block(const void* pos, const void* table, void* out,
                          long long n, int num_levels, int features_per_level,
                          long long rows_per_level, long long hash_table_size,
                          const int* resolutions, int exact, int design, unsigned level_magic,
                          unsigned level_shift, unsigned block_magic, unsigned block_shift, void* stream) {
  LevelGeometry g;
  const cudaError_t bad = make_geometry(n, num_levels, rows_per_level, hash_table_size, resolutions, &g);
  if (bad != cudaSuccess) return (int)bad;
  if (n == 0) return (int)cudaSuccess;
  const uint32_t nblocks = (uint32_t)(hash_table_size / 8);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)pos;
  const float* tab = (const float*)table;
  float* o = (float*)out;
  if (design == 0) {
    const cudaError_t err =
        exact ? launch<true>(features_per_level, p, tab, o, n, rows_per_level, nblocks, g, s)
              : launch<false>(features_per_level, p, tab, o, n, rows_per_level, nblocks, g, s);
    return (int)err;
  }
  if (design != 1 || (features_per_level != 2 && features_per_level != 4) ||
      (uint64_t)n * (uint64_t)num_levels >= (1ull << 31) ||
      (uint64_t)num_levels * (uint64_t)rows_per_level * kLanes >= (1ull << 32) || (uintptr_t)table % 16 != 0)
    return (int)cudaErrorInvalidValue;
  LaneArgs a;
  a.pos = p;
  a.table = tab;
  a.out = o;
  a.n = (uint32_t)n;
  a.level_stride = (uint32_t)(rows_per_level * kLanes);
  a.levels = {(uint32_t)num_levels, level_magic, level_shift};
  a.nblocks = {nblocks, block_magic, block_shift};
  if (features_per_level == 2)
    launch_lanes<2>(exact, a, s, g);
  else
    launch_lanes<4>(exact, a, s, g);
  return (int)cudaGetLastError();
}

// K1 backward. pos (n, 3), table (num_levels, rows_per_level, 128) and grad
// (n, num_levels * features_per_level) are f32 device inputs. d_table, of
// the table's shape, must be zeroed by the caller and receives the table
// gradient; d_pos (n, 3) receives the position gradient. Either may be
// null to skip that output. scales is a host array of num_levels floats.
// Returns a cudaError_t (0 on success).
int nst_hash_encode_block_bwd(const void* pos, const void* table, const void* grad,
                              void* d_table, void* d_pos, long long n, int num_levels,
                              int features_per_level, long long rows_per_level,
                              long long hash_table_size, const int* resolutions,
                              const float* scales, void* stream) {
  LevelGeometry g;
  const cudaError_t bad = make_geometry(n, num_levels, rows_per_level, hash_table_size, resolutions, &g);
  if (bad != cudaSuccess) return (int)bad;
  if (n == 0 || (d_table == nullptr && d_pos == nullptr)) return (int)cudaSuccess;
  LevelScales sc;
  for (int l = 0; l < num_levels; ++l) sc.scale[l] = scales[l];
  const uint32_t nblocks = (uint32_t)(hash_table_size / 8);
  const unsigned int grid = (unsigned int)((n + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)pos;
  const float* tab = (const float*)table;
  const float* gr = (const float*)grad;
  float* dt = (float*)d_table;
  float* dp = (float*)d_pos;
  switch (features_per_level) {
    case 1:
      block_encode_bwd_kernel<1><<<grid, kThreads, 0, s>>>(p, tab, gr, dt, dp, n, rows_per_level, nblocks, g, sc);
      break;
    case 2:
      block_encode_bwd_kernel<2><<<grid, kThreads, 0, s>>>(p, tab, gr, dt, dp, n, rows_per_level, nblocks, g, sc);
      break;
    case 4:
      block_encode_bwd_kernel<4><<<grid, kThreads, 0, s>>>(p, tab, gr, dt, dp, n, rows_per_level, nblocks, g, sc);
      break;
    case 8:
      block_encode_bwd_kernel<8><<<grid, kThreads, 0, s>>>(p, tab, gr, dt, dp, n, rows_per_level, nblocks, g, sc);
      break;
    case 16:
      block_encode_bwd_kernel<16><<<grid, kThreads, 0, s>>>(p, tab, gr, dt, dp, n, rows_per_level, nblocks, g, sc);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K7 forward (flat layout). pos (n, 3), table (num_levels, rows_per_level,
// 128) and out (n, num_levels * features_per_level) are contiguous f32
// device pointers; resolutions is a host array of num_levels ints.
// Returns a cudaError_t (0 on success).
int nst_hash_encode_flat(const void* pos, const void* table, void* out, long long n, int num_levels,
                         int features_per_level, long long rows_per_level, long long hash_table_size,
                         const int* resolutions, void* stream) {
  FlatGeometry g;
  const cudaError_t bad = make_flat_geometry(n, num_levels, rows_per_level, hash_table_size, resolutions, &g);
  if (bad != cudaSuccess) return (int)bad;
  if (n == 0) return (int)cudaSuccess;
  const unsigned int grid = (unsigned int)((n * num_levels + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)pos;
  const float* tab = (const float*)table;
  float* o = (float*)out;
  const int64_t stride = rows_per_level * kLanes;
  const uint32_t t = (uint32_t)hash_table_size;
  switch (features_per_level) {
    case 1: flat_encode_kernel<1><<<grid, kThreads, 0, s>>>(p, tab, o, n, stride, t, g); break;
    case 2: flat_encode_kernel<2><<<grid, kThreads, 0, s>>>(p, tab, o, n, stride, t, g); break;
    case 4: flat_encode_kernel<4><<<grid, kThreads, 0, s>>>(p, tab, o, n, stride, t, g); break;
    case 8: flat_encode_kernel<8><<<grid, kThreads, 0, s>>>(p, tab, o, n, stride, t, g); break;
    case 16: flat_encode_kernel<16><<<grid, kThreads, 0, s>>>(p, tab, o, n, stride, t, g); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K7 backward. pos, table and grad as for the forward (grad of out's
// shape). d_table, of the table's shape, must be zeroed by the caller and
// receives the table gradient; d_pos (n, 3) receives the position
// gradient. Either may be null to skip it. Returns a cudaError_t.
int nst_hash_encode_flat_bwd(const void* pos, const void* table, const void* grad, void* d_table,
                             void* d_pos, long long n, int num_levels, int features_per_level,
                             long long rows_per_level, long long hash_table_size, const int* resolutions,
                             void* stream) {
  FlatGeometry g;
  const cudaError_t bad = make_flat_geometry(n, num_levels, rows_per_level, hash_table_size, resolutions, &g);
  if (bad != cudaSuccess) return (int)bad;
  if (n == 0 || (d_table == nullptr && d_pos == nullptr)) return (int)cudaSuccess;
  const unsigned int grid = (unsigned int)((n + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)pos;
  const float* tab = (const float*)table;
  const float* gr = (const float*)grad;
  float* dt = (float*)d_table;
  float* dp = (float*)d_pos;
  const int64_t stride = rows_per_level * kLanes;
  const uint32_t t = (uint32_t)hash_table_size;
  switch (features_per_level) {
    case 1: flat_encode_bwd_kernel<1><<<grid, kThreads, 0, s>>>(p, tab, gr, dt, dp, n, stride, t, g); break;
    case 2: flat_encode_bwd_kernel<2><<<grid, kThreads, 0, s>>>(p, tab, gr, dt, dp, n, stride, t, g); break;
    case 4: flat_encode_bwd_kernel<4><<<grid, kThreads, 0, s>>>(p, tab, gr, dt, dp, n, stride, t, g); break;
    case 8: flat_encode_bwd_kernel<8><<<grid, kThreads, 0, s>>>(p, tab, gr, dt, dp, n, stride, t, g); break;
    case 16: flat_encode_bwd_kernel<16><<<grid, kThreads, 0, s>>>(p, tab, gr, dt, dp, n, stride, t, g); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* nst_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
