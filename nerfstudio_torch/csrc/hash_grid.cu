// Multiresolution hash-grid encode, block and flat layouts, forward and
// backward, for Hopper (sm_90a). Plain C interface, loaded with ctypes by
// nerfstudio_torch/ops/hash_grid.py.
//
// Replaces, in the JAX reference package:
//   * K7 fwd and bwd: nerfstudio_tpu/ops/hash_grid.py hash_encode's flat
//     8-corner path (:991-1031) through _row_gather_select (:62-107) and
//     _hash_corner (:732): flat_encode_kernel and flat_lanes_kernel (the
//     forward's two designs), flat_encode_bwd_kernel below.
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
//   * K3b: XLA's autodiff of _block_exact_trilerp (hash_encode(block_exact=
//     True) under jax.grad in the positions; the eval normals):
//     block_exact_bwd_kernel.
//   * K1bb: XLA's autodiff of K1's backward (the same functions
//     differentiated again, for the cotangent of its position gradient; the
//     normals' loss in training): block_bwd_bwd_kernel.
//
// K7's forward has the same two designs: one thread per (sample, level)
// (flat_encode_kernel) and, for F = 2 and 4, lane pairs with one level per
// warp, whose load instructions take a z-pair of corners of 16
// neighbouring samples (flat_lanes_kernel).
//
// Both backward kernels (K1 bwd, K7 bwd) have two designs too: one thread
// per sample walking the levels with scalar atomics (block_encode_bwd_kernel,
// flat_encode_bwd_kernel), and, for F = 2 and 4, lane groups with vector
// reductions (bwd_lanes_kernel), before which K7, asked for the table
// gradient alone, reduces its dense coarse levels in shared memory
// (bwd_private_kernel). See the comment above bwd_private_kernel.
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

// The arguments of the forward lane kernels (K1, K3, K7).
struct LaneArgs {
  const float* pos;
  const float* table;
  float* out;
  uint32_t n;
  uint32_t level_stride;  // floats; the whole table holds fewer than 2^32
  U32Divisor levels;      // d = the level count
  U32Divisor modulus;     // K1, K3: T / 8 (the block hash); K7: T (the entry hash)
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
                                 : umod(bc[0][dx] ^ bc[1][dy] ^ bc[2][dz], a.modulus);
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
                                        : umod(bc[0] ^ (bc[1] * 2654435761u) ^ (bc[2] * 805459861u), a.modulus);
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
// hundred rows. The first design, kept for F in {1, 8, 16} and for
// chip_smoke.py's comparison; F = 2 and 4 take the second (bwd_lanes_kernel
// and bwd_private_kernel below).
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

// K7 forward, the first design ("per-thread"). One thread per (sample,
// level), level fastest, as K1. The eight corners are summed in the
// reference's order 0..7 of c = dx<<2 | dy<<1 | dz, each term
// w_c * bf16(value) with w_c = ((x-weight * y-weight) * z-weight), all
// rounded as the reference rounds them, so the output is bit-exact.
//
// What bounds it: eight random F-float gathers per (sample, level), each
// in its own 32-byte sector on the hashed levels (the dense coarse levels
// stay in L2), against a few dozen flops. Latency and sector count of the
// loads, not flops. Kept for F in {1, 8, 16}, which no shipped config
// uses, and so that chip_smoke.py can time it beside flat_lanes_kernel.
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

// K7's stencil at one level: each corner's entry offset within the level
// (floats), its weight ((wx*wy)*wz, as the forward), and each axis's upper
// weight o.
template <int F>
__device__ __forceinline__ void flat_stencil(const float p[3], int res, bool dense, const U32Divisor& t,
                                             uint32_t off[8], float w[8], float w1[3]) {
  int i0[3];
  float wa[3][2];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    flat_axis(p[ax], res, &i0[ax], &w1[ax]);
    wa[ax][0] = __fsub_rn(1.0f, w1[ax]);
    wa[ax][1] = w1[ax];
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int dx = (c >> 2) & 1, dy = (c >> 1) & 1, dz = c & 1;
    uint32_t e;
    if (dense) {
      const uint32_t side = (uint32_t)res + 1u;
      const uint32_t cx = (uint32_t)min(max(i0[0] + dx, 0), res), cy = (uint32_t)min(max(i0[1] + dy, 0), res),
                     cz = (uint32_t)min(max(i0[2] + dz, 0), res);
      e = (cx * side + cy) * side + cz;
    } else {
      e = umod((uint32_t)(i0[0] + dx) ^ ((uint32_t)(i0[1] + dy) * 2654435761u) ^
                   ((uint32_t)(i0[2] + dz) * 805459861u), t);
    }
    off[c] = e * F;
    w[c] = __fmul_rn(__fmul_rn(wa[0][dx], wa[1][dy]), wa[2][dz]);
  }
}

// K7 forward, lane groups (F = 2 and 4, where it is the default design).
// What bounds the per-thread design above: its warps mix the levels (and
// so the dense and the hashed index paths, which then run one after the
// other), and one load instruction of a warp asks for corner c of 32
// stencils, six samples at five levels, of which at most six can share a
// cell where neighbouring samples do. Here a block takes kFlatSamples
// consecutive samples and warp l their level l (blockDim = 32 * levels),
// 16 samples at a time: lanes 2j and 2j + 1 serve sample j. Each lane of
// the pair computes the cells and the four corners of its z parity b
// (corners 2k + b) and loads them as float2 (F=2) or float4 (F=4), so one
// load instruction of the warp covers a z-pair of corners (neighbouring
// entries of a dense level) of 16 neighbouring samples of one level, which
// along a ray share cells. Each lane rounds its values to bf16 and weights
// them; the odd lane hands its four products to the even one by shuffles,
// which adds the eight in the reference's order 0..7, rounded as the twin
// rounds them (bit-equal), into the block's output rows in shared memory;
// the block then stores its rows, which are contiguous in the output. An
// earlier lane-group design (8 lanes per stencil, one corner each, levels
// mixed in a warp) lost to the per-thread design at a neus-facto eval
// chunk's inputs, and one that handed each stencil's corners through
// shared memory lost to this one (PERF.md).
constexpr int kFlatSamples = 32;

template <int F>
__global__ void __launch_bounds__(32 * kMaxLevels) flat_lanes_kernel(LaneArgs a, LevelGeometry g) {
  extern __shared__ float4 smem4[];
  const int L = (int)a.levels.d;
  const unsigned lane = threadIdx.x & 31u;
  const int l = threadIdx.x >> 5;
  float* rows = reinterpret_cast<float*>(smem4);  // [sample][level][F]
  const uint32_t i0 = blockIdx.x * kFlatSamples;
  const uint32_t count = min(a.n - i0, (uint32_t)kFlatSamples);
  const int res = g.res[l];
  const bool dense = g.dense[l] != 0;
  const uint32_t base = (uint32_t)l * a.level_stride;
  const uint32_t b = lane & 1u;  // the lane's z parity: corners 2k + b
#pragma unroll
  for (uint32_t h = 0; h < kFlatSamples / 16; ++h) {
    const uint32_t j = 16u * h + (lane >> 1);
    const bool valid = j < count;
    float prod[4][F];
    if (valid) {
      int i0a[3];
      float wa[3][2];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        float o;
        flat_axis(__ldg(a.pos + 3 * (size_t)(i0 + j) + ax), res, &i0a[ax], &o);
        wa[ax][0] = __fsub_rn(1.0f, o);
        wa[ax][1] = o;
      }
      uint32_t off[4];
      float w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int dx = k >> 1, dy = k & 1, dz = (int)b;
        uint32_t e;
        if (dense) {
          const uint32_t side = (uint32_t)res + 1u;
          const uint32_t cx = (uint32_t)min(max(i0a[0] + dx, 0), res), cy = (uint32_t)min(max(i0a[1] + dy, 0), res),
                         cz = (uint32_t)min(max(i0a[2] + dz, 0), res);
          e = (cx * side + cy) * side + cz;
        } else {
          e = umod((uint32_t)(i0a[0] + dx) ^ ((uint32_t)(i0a[1] + dy) * 2654435761u) ^
                       ((uint32_t)(i0a[2] + dz) * 805459861u), a.modulus);
        }
        off[k] = base + e * F;
        w[k] = __fmul_rn(__fmul_rn(wa[0][dx], wa[1][dy]), wa[2][dz]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v[F];
        if constexpr (F == 4) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(a.table + off[k]));
          v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
          bf16_round2(v[2], v[3]);
        } else {
          const float2 x = __ldg(reinterpret_cast<const float2*>(a.table + off[k]));
          v[0] = x.x, v[1] = x.y;
        }
        bf16_round2(v[0], v[1]);
#pragma unroll
        for (int f = 0; f < F; ++f) prod[k][f] = __fmul_rn(w[k], v[f]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int f = 0; f < F; ++f) prod[k][f] = 0.0f;
    }
    float odd[4][F];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int f = 0; f < F; ++f) odd[k][f] = __shfl_down_sync(0xffffffffu, prod[k][f], 1);
    if (valid && b == 0u) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float acc = prod[0][f];
        acc = __fadd_rn(acc, odd[0][f]);
#pragma unroll
        for (int k = 1; k < 4; ++k) acc = __fadd_rn(__fadd_rn(acc, prod[k][f]), odd[k][f]);
        rows[(j * L + l) * F + f] = acc;
      }
    }
  }
  __syncthreads();
  float* out = a.out + (size_t)i0 * L * F;
  for (uint32_t t = threadIdx.x; t < count * L * F; t += blockDim.x) out[t] = rows[t];
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
// so those atomics contend. The first design, kept as K1's backward is;
// F = 2 and 4 take the second (below).
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

// ---------------------------------------------------------------------------
// The backward's second design, K1 bwd and K7 bwd at F = 2 and 4.
//
// What bounds the first design (block_encode_bwd_kernel,
// flat_encode_bwd_kernel above): 8F scalar f32 atomics per (sample, level),
// and on the dense coarse levels every sample's atomics land on a few
// thousand addresses, where same-address atomics serialise in L2 (K7's
// level 0 takes ~850 atomics per float at the proposal nets' 524,288
// positions). The position gradient re-reads each corner with F scalar
// loads. Up to three kernels, launched by one C call:
//
//   * bwd_private_kernel (K7 only, and only when the table gradient alone is
//     asked: with the position gradient the lane pass walks every level
//     anyway, and the private pass lost there, PERF.md) owns the table
//     gradient of the levels the host's plan privatises (hash_grid.bwd_plan):
//     dense levels whose copies fit one block's shared memory together
//     (levels 0-1 of the proposal nets at F=2, 192 KB). Each block zeroes its
//     copy and walks a
//     contiguous range of samples, a warp of 32 consecutive samples at a
//     time: the terms of a run of lanes with the same stencil (ray-ordered
//     samples share a coarse cell for several steps) are summed by a
//     segmented warp scan, and the run's sums go to the copy with shared f32
//     atomics. The block stores its copy to a scratch slab of its own;
//     bwd_private_sum_kernel adds the slabs in block order and stores the
//     sums. Global reductions of each block's copy instead of the slabs hit
//     the same few thousand addresses from every block and cost more than
//     the scatter they saved. K1 takes no private pass: its lane pass walks
//     every level for the positions anyway, and its level 0's vector
//     reductions cost no more than another level's (PERF.md).
//   * bwd_lanes_kernel takes the other levels' table gradient and every
//     level's position gradient, in K1's and K3's lane-group structure (see
//     block_stochastic_lanes_kernel): lane s of a warp computes stencil s's
//     geometry once and writes it to a per-warp table in shared memory, then
//     a group of G lanes serves each stencil. K7: 8 lanes, one corner each,
//     its F floats as one 8- or 16-byte vector; K1: 2F lanes, one 16-byte
//     quarter of the 8F-float block each. A lane adds its weighted
//     cotangent with one vector reduction (atomicAdd on float2/float4,
//     native for global memory on sm_90: one reduction where the first
//     design issued F or 4), and for the position gradient loads the same
//     vector, forms its corners' d_w = <g, bf16 value> terms of the three
//     axes' d_o, and the group sums them with shuffles. A warp holds
//     32 / levels whole samples, levels fastest, so each sample's levels
//     sum in shared memory in level order and d_pos is written once, with
//     no atomic.
//
// Numerics: every term is rounded as the first design rounds it (w*g, or
// (w*g)*scale for K1) and only the summation tree changes, so the
// summation-order bounds of chip_smoke.py hold as they are (warp scans and
// slab sums are subtrees of that sum). Levels of
// scale 0 write nothing; corners of weight 0 add nothing, except a K1 lane
// at F=2 whose 16 bytes hold one live and one dead corner, which adds an
// exact +-0 to the dead one.
//
// Index math is 32-bit, as the forward's lane kernels: n * num_levels <
// 2^31, a table of fewer than 2^32 floats, table and gradient 16-byte
// aligned; the hash's modulus is hash_grid._u32_divisor's multiply-high.

constexpr int kPrivThreads = 1024;
// one block's opt-in maximum on the H100; hash_grid.bwd_plan plans against
// its own copy (SHARED_BYTES_PER_BLOCK) and make_bwd_levels re-checks here
constexpr int kMaxSharedBytes = 232448;

struct BwdArgs {
  const float* pos;
  const float* table;
  const float* grad;
  float* d_table;  // null: no table gradient
  float* d_pos;    // null: no position gradient
  uint32_t n;
  uint32_t num_levels;
  uint32_t level_stride;  // floats
  U32Divisor modulus;     // K1: T/8 (the block hash), K7: T (the entry hash)
};

// The levels of the two passes, from the host's plan (make_bwd_levels).
struct BwdLevels {
  int lane_count;               // levels the lane pass runs, in order
  int lane_level[kMaxLevels];
  float scale[kMaxLevels];      // factor on the table gradient the lane pass adds (K7: 1); 0: none
  int private_count;            // levels the private pass owns, in order (K7 only)
  int private_level[kMaxLevels];
  uint32_t private_base[kMaxLevels];    // float offset of a level's copy in shared memory
  uint32_t private_floats[kMaxLevels];  // its floats, a multiple of 4
  uint32_t shared_floats;               // all copies
};

// K1's stencil at one level, with the forward's arithmetic: returns the
// block index; w are the eight corner weights, w1 each axis's upper weight
// (o on an even axis, the coin's 0/1 on an odd one) and fx each axis's
// d_x / d_o: 0 on an odd axis, else res * clip'(x*res - i0), clip' 1 inside
// (0, 1), 1/2 on exactly 0 or 1 (jnp.clip's max/min pair), 0 outside.
__device__ __forceinline__ uint32_t block_stencil(const float p[3], int res, uint32_t bs, bool dense,
                                                  const U32Divisor& nblocks, float w[8], float w1[3],
                                                  float fx[3]) {
  uint32_t bc[3];
  float w01[3][2];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float s = __fmul_rn(p[ax], (float)res);
    int c = (int)floorf(s);
    c = min(max(c, 0), res - 1);
    const float t = __fsub_rn(s, (float)c);
    const float o = fminf(fmaxf(t, 0.0f), 1.0f);
    const bool odd = (c & 1) == 1;
    const bool up = u01_hash(o, kCoinPrimes[ax][0], kCoinPrimes[ax][1]) < o;
    bc[ax] = (uint32_t)(c + ((odd && up) ? 1 : 0)) >> 1;
    const float upf = up ? 1.0f : 0.0f;
    w01[ax][0] = odd ? upf : __fsub_rn(1.0f, o);
    w01[ax][1] = odd ? __fsub_rn(1.0f, upf) : o;
    w1[ax] = w01[ax][1];
    fx[ax] = odd ? 0.0f
             : (t > 0.0f && t < 1.0f)   ? (float)res
             : (t == 0.0f || t == 1.0f) ? 0.5f * (float)res
                                        : 0.0f;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c)
    w[c] = __fmul_rn(__fmul_rn(w01[0][(c >> 2) & 1], w01[1][(c >> 1) & 1]), w01[2][c & 1]);
  return dense ? (bc[0] * bs + bc[1]) * bs + bc[2] : umod(bc[0] ^ (bc[1] * 2654435761u) ^ (bc[2] * 805459861u), nblocks);
}

// Corner c's terms of d_o on the three axes: d_w * (+1 if c is up on the
// axis, else -1) * (the other two axes' weights), each axis's lower weight
// 1 - w1 as the forward rounds it; added to t.
__device__ __forceinline__ void add_corner_terms(float dw, int c, const float w1[3], float t[3]) {
  float w01[3][2];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    w01[ax][0] = __fsub_rn(1.0f, w1[ax]);
    w01[ax][1] = w1[ax];
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int b1 = a == 0 ? 1 : 0, b2 = a == 2 ? 1 : 2;  // the other two axes
    const float other = __fmul_rn(w01[b1][(c >> (2 - b1)) & 1], w01[b2][(c >> (2 - b2)) & 1]);
    const float term = __fmul_rn(dw, other);
    t[a] = ((c >> (2 - a)) & 1) ? __fadd_rn(t[a], term) : __fsub_rn(t[a], term);
  }
}

// K7's table-gradient pass of the privatised levels. Dynamic shared memory:
// lv.shared_floats floats, the levels' copies side by side. The block walks
// its contiguous range of samples 32 consecutive samples per warp at a
// time. Ray-ordered samples that share a coarse stencil are runs of
// consecutive lanes: per level, a segmented scan (shuffles, as deep as the
// warp's longest run) sums each run's terms, and the run's last lane adds
// the sums to the copy with shared f32 atomics, one per nonzero float. The
// block then stores its copy to its slab of `partial` (gridDim.x slabs of
// lv.shared_floats floats); bwd_private_sum_kernel adds the slabs.
template <int F>
__global__ void __launch_bounds__(kPrivThreads, 1)
    bwd_private_kernel(BwdArgs a, LevelGeometry g, BwdLevels lv, float* __restrict__ partial) {
  extern __shared__ float4 copies4[];
  float* copies = reinterpret_cast<float*>(copies4);
  const uint32_t floats4 = lv.shared_floats / 4;
  for (uint32_t j = threadIdx.x; j < floats4; j += kPrivThreads) copies4[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  const unsigned lane = threadIdx.x & 31u;
  const uint32_t chunk = (a.n + gridDim.x - 1) / gridDim.x;
  const uint32_t start = blockIdx.x * chunk;
  const uint32_t end = min(a.n, start + chunk);
  for (uint32_t t0 = start + (threadIdx.x & ~31u); t0 < end; t0 += kPrivThreads) {  // the same for the whole warp
    const uint32_t i = t0 + lane;
    const bool valid = i < end;  // a lane past the end adds zero terms
    float p[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) p[ax] = valid ? __ldg(a.pos + 3 * (size_t)i + ax) : 0.0f;
    for (int k = 0; k < lv.private_count; ++k) {
      const int l = lv.private_level[k];
      float gv[F], w[8], w1[3];
#pragma unroll
      for (int f = 0; f < F; ++f) gv[f] = valid ? __ldg(a.grad + ((size_t)i * a.num_levels + l) * F + f) : 0.0f;
      uint32_t o[8];
      flat_stencil<F>(p, g.res[l], true, a.modulus, o, w, w1);
      // runs of lanes with one stencil (a dense level's stencil is fixed by
      // its first and last corner): each lane's run head, the run's last
      // lane, the warp's longest run
      const uint32_t prev0 = __shfl_up_sync(0xffffffffu, o[0], 1), prev7 = __shfl_up_sync(0xffffffffu, o[7], 1);
      const bool head = lane == 0 || prev0 != o[0] || prev7 != o[7];
      const unsigned heads = __ballot_sync(0xffffffffu, head);
      const unsigned first = 31u - __clz(heads & (0xffffffffu >> (31u - lane)));
      const bool last = lane == 31u || ((heads >> (lane + 1u)) & 1u) != 0u;
      const unsigned longest = __reduce_max_sync(0xffffffffu, lane - first + 1u);
      float* dst = copies + lv.private_base[k];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float v[F];
#pragma unroll
        for (int f = 0; f < F; ++f) v[f] = __fmul_rn(w[c], gv[f]);
#pragma unroll
        for (unsigned d = 1; d < 32u; d <<= 1) {
          if (d >= longest) break;  // the same for the whole warp
#pragma unroll
          for (int f = 0; f < F; ++f) {
            const float up = __shfl_up_sync(0xffffffffu, v[f], d);
            if (lane >= first + d) v[f] = __fadd_rn(v[f], up);
          }
        }
        if (last) {
#pragma unroll
          for (int f = 0; f < F; ++f)
            if (v[f] != 0.0f) atomicAdd(dst + o[c] + f, v[f]);
        }
      }
    }
  }
  __syncthreads();
  float4* slab = reinterpret_cast<float4*>(partial + (size_t)blockIdx.x * lv.shared_floats);
  for (uint32_t j = threadIdx.x; j < floats4; j += kPrivThreads) slab[j] = copies4[j];
}

// Sum the private pass's slabs in block order (one thread per 16 bytes of
// the copies) and store the sum into the table gradient, where the lane
// pass writes nothing. Only this sum across blocks has a fixed order: within
// a block the runs' sums reach the copy through shared atomics in the order
// the warps arrive, so the last bits may differ from run to run.
__global__ void __launch_bounds__(kThreads)
    bwd_private_sum_kernel(const float* __restrict__ partial, uint32_t blocks, BwdLevels lv,
                           float* __restrict__ d_table, uint32_t level_stride) {
  const uint32_t floats4 = lv.shared_floats / 4;
  const uint32_t j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= floats4) return;
  const float4* slabs = reinterpret_cast<const float4*>(partial);
  float4 s = slabs[j];
  for (uint32_t b = 1; b < blocks; ++b) {
    const float4 v = slabs[(size_t)b * floats4 + j];
    s.x = __fadd_rn(s.x, v.x), s.y = __fadd_rn(s.y, v.y), s.z = __fadd_rn(s.z, v.z), s.w = __fadd_rn(s.w, v.w);
  }
  int k = 0;
  while (4 * j >= lv.private_base[k] + lv.private_floats[k]) ++k;
  float* dst = d_table + (size_t)lv.private_level[k] * level_stride + (4 * j - lv.private_base[k]);
  *reinterpret_cast<float4*>(dst) = s;
}

// The lane pass: table gradient of the levels the private pass does not
// own (scale != 0), position gradient of every level.
template <int F, bool kBlock>
__global__ void __launch_bounds__(kThreads) bwd_lanes_kernel(BwdArgs a, LevelGeometry g, BwdLevels lv) {
  constexpr int kWarps = kThreads / 32;
  constexpr int G = kBlock ? 2 * F : 8;         // lanes per stencil
  constexpr int R = 32 / G;                     // stencils per round
  constexpr int kCorners = kBlock ? 4 / F : 1;  // corners per lane
  constexpr int kVec = kCorners * F;            // floats per lane: 2 or 4
  __shared__ uint32_t offsets[kWarps][kBlock ? 32 : 8 * 32];  // K1: block; K7: corners (slot layout)
  __shared__ float weights[kWarps][8 * 32];                   // slot layout, kCorners per slot
  __shared__ float grads[kWarps][32 * F];
  __shared__ float scales[kWarps][32];
  __shared__ float w1s[kWarps][3 * 32];
  __shared__ float fxs[kWarps][3 * 32];
  __shared__ float dxs[kWarps][3 * 32];
  const unsigned lane = threadIdx.x & 31u;
  const int warp = threadIdx.x >> 5;
  const int lc = lv.lane_count;
  const int spw = 32 / lc;  // whole samples per warp
  const int js = (int)lane / lc, ls = (int)lane - js * lc;
  const uint32_t i = (blockIdx.x * kWarps + warp) * (uint32_t)spw + (uint32_t)js;
  const bool valid = js < spw && i < a.n;  // a prefix of the warp's lanes
  const bool need_pos = a.d_pos != nullptr;
  if (valid) {
    const int l = lv.lane_level[ls];
    float p[3];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) p[ax] = __ldg(a.pos + 3 * (size_t)i + ax);
    const uint32_t base = (uint32_t)l * a.level_stride;
    float w[8], w1[3], fx[3];
    if constexpr (kBlock) {
      const uint32_t blk =
          block_stencil(p, g.res[l], (uint32_t)g.blocks_per_axis[l], g.dense[l] != 0, a.modulus, w, w1, fx);
      offsets[warp][lane] = base + blk * (8 * F);
#pragma unroll
      for (int k = 0; k < G; ++k) {
#pragma unroll
        for (int m = 0; m < kCorners; ++m) weights[warp][slot<R>(k, lane) * kCorners + m] = w[k * kCorners + m];
      }
    } else {
      uint32_t off[8];
      flat_stencil<F>(p, g.res[l], g.dense[l] != 0, a.modulus, off, w, w1);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        offsets[warp][slot<R>(c, lane)] = base + off[c];
        weights[warp][slot<R>(c, lane)] = w[c];
      }
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) fx[ax] = (float)g.res[l];
    }
#pragma unroll
    for (int f = 0; f < F; ++f) grads[warp][lane * F + f] = __ldg(a.grad + ((size_t)i * a.num_levels + l) * F + f);
    scales[warp][lane] = lv.scale[l];
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      w1s[warp][3 * lane + ax] = w1[ax];
      fxs[warp][3 * lane + ax] = fx[ax];
    }
  }
  const int count = __popc(__ballot_sync(0xffffffffu, valid));
  if (count == 0) return;  // the same for the whole warp
  __syncwarp();
  const int k = lane & (G - 1), q = lane / G;
#pragma unroll 2
  for (int r = 0; r < 32 / R; ++r) {
    if (R * r >= count) break;  // the same for the whole warp
    const int s = R * r + q;
    const bool live = s < count;
    const int ss = live ? s : 0;
    float gv[F];
#pragma unroll
    for (int f = 0; f < F; ++f) gv[f] = grads[warp][ss * F + f];
    const float sc = live ? scales[warp][ss] : 0.0f;
    uint32_t off;
    float wc[kCorners];
    if constexpr (kBlock) {
      off = offsets[warp][ss] + 4 * k;
#pragma unroll
      for (int m = 0; m < kCorners; ++m) wc[m] = weights[warp][slot<R>(k, ss) * kCorners + m];
    } else {
      off = offsets[warp][slot<R>(k, ss)];
      wc[0] = weights[warp][slot<R>(k, ss)];
    }
    bool any = false;
#pragma unroll
    for (int m = 0; m < kCorners; ++m) any = any || wc[m] != 0.0f;
    if (sc != 0.0f && any) {
      float v[kVec];
#pragma unroll
      for (int m = 0; m < kCorners; ++m) {
#pragma unroll
        for (int f = 0; f < F; ++f)
          v[m * F + f] = kBlock ? __fmul_rn(__fmul_rn(wc[m], gv[f]), sc) : __fmul_rn(wc[m], gv[f]);
      }
      if constexpr (kVec == 4)
        atomicAdd(reinterpret_cast<float4*>(a.d_table + off), make_float4(v[0], v[1], v[2], v[3]));
      else
        atomicAdd(reinterpret_cast<float2*>(a.d_table + off), make_float2(v[0], v[1]));
    }
    if (need_pos) {  // the same for the whole grid
      float tv[kVec];
      const float* src = a.table + (live ? off : 0u);
      if constexpr (kVec == 4) {
        const float4 x = __ldg(reinterpret_cast<const float4*>(src));
        tv[0] = x.x, tv[1] = x.y, tv[2] = x.z, tv[3] = x.w;
        bf16_round2(tv[2], tv[3]);
      } else {
        const float2 x = __ldg(reinterpret_cast<const float2*>(src));
        tv[0] = x.x, tv[1] = x.y;
      }
      bf16_round2(tv[0], tv[1]);
      float w1[3];
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) w1[ax] = w1s[warp][3 * ss + ax];
      float t[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int m = 0; m < kCorners; ++m) {
        float dw = 0.0f;
#pragma unroll
        for (int f = 0; f < F; ++f) dw = __fadd_rn(dw, __fmul_rn(gv[f], tv[m * F + f]));
        add_corner_terms(dw, kBlock ? k * kCorners + m : k, w1, t);
      }
#pragma unroll
      for (int o = G / 2; o >= 1; o >>= 1) {
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) t[ax] = __fadd_rn(t[ax], __shfl_xor_sync(0xffffffffu, t[ax], o));
      }
      if (live && k == 0) {
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          const float fx = fxs[warp][3 * ss + ax];
          dxs[warp][3 * ss + ax] = fx != 0.0f ? __fmul_rn(t[ax], fx) : 0.0f;
        }
      }
    }
  }
  if (need_pos) {
    __syncwarp();
    if (valid && ls == 0) {  // the sample's first stencil sums its levels in order
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        float acc = 0.0f;
        for (int m = 0; m < lc; ++m) acc = __fadd_rn(acc, dxs[warp][3 * ((int)lane + m) + ax]);
        a.d_pos[3 * (size_t)i + ax] = acc;
      }
    }
  }
}

template <int F, bool kBlock>
cudaError_t launch_bwd_lanes(const BwdArgs& a, const LevelGeometry& g, const BwdLevels& lv, float* partial,
                             uint32_t private_blocks, cudaStream_t s) {
  if (!kBlock && lv.private_count > 0) {
    // the opt-in above 48 KB, raised to the maximum once per process (the
    // port drives one card)
    static bool raised = false;
    cudaError_t err;
    if (!raised) {
      err = cudaFuncSetAttribute(bwd_private_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSharedBytes);
      if (err != cudaSuccess) return err;
      raised = true;
    }
    const int bytes = (int)lv.shared_floats * 4;
    bwd_private_kernel<F><<<private_blocks, kPrivThreads, bytes, s>>>(a, g, lv, partial);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const uint32_t sum_grid = (lv.shared_floats / 4 + kThreads - 1) / kThreads;
    bwd_private_sum_kernel<<<sum_grid, kThreads, 0, s>>>(partial, private_blocks, lv, a.d_table, a.level_stride);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (lv.lane_count > 0) {
    const uint32_t spw = 32u / (uint32_t)lv.lane_count;
    const uint32_t warps = (a.n + spw - 1) / spw;
    const uint32_t grid = (warps + kThreads / 32 - 1) / (kThreads / 32);
    bwd_lanes_kernel<F, kBlock><<<grid, kThreads, 0, s>>>(a, g, lv);
  }
  return cudaGetLastError();
}

// The passes' levels from the host's plan (bit l of private_mask
// privatises level l), checked: only K7 privatises, and only when the
// position gradient is not asked; a privatised level must be dense and get
// a table gradient, and shared_bytes must be its copies'
// bytes as hash_grid.bwd_plan counts them ((res+1)^3 * F floats rounded up
// to a multiple of 4), at most kMaxSharedBytes. scales: K1's per-level
// factors, null for K7 (1 on every level). Returns cudaErrorInvalidValue for
// a plan the planner does not produce.
cudaError_t make_bwd_levels(bool block, int features, const LevelGeometry& g, const float* scales,
                            bool need_table, bool need_pos, unsigned private_mask, long long shared_bytes,
                            BwdLevels* lv) {
  if (((block || need_pos) && private_mask != 0) || (g.num_levels < 32 && (private_mask >> g.num_levels) != 0))
    return cudaErrorInvalidValue;
  lv->lane_count = 0;
  lv->private_count = 0;
  uint64_t total = 0;
  for (int l = 0; l < g.num_levels; ++l) {
    const float sc = need_table ? (block ? scales[l] : 1.0f) : 0.0f;
    const bool priv = ((private_mask >> l) & 1u) != 0;
    if (priv) {
      if (!g.dense[l] || sc == 0.0f) return cudaErrorInvalidValue;
      const uint64_t side = (uint64_t)g.res[l] + 1;
      const uint64_t floats = (side * side * side * features + 3) / 4 * 4;
      if (total + floats > (uint64_t)kMaxSharedBytes / 4) return cudaErrorInvalidValue;
      const int k = lv->private_count++;
      lv->private_level[k] = l;
      lv->private_base[k] = (uint32_t)total;
      lv->private_floats[k] = (uint32_t)floats;
      total += floats;
    }
    lv->scale[l] = priv ? 0.0f : sc;
    if (lv->scale[l] != 0.0f || need_pos) lv->lane_level[lv->lane_count++] = l;
  }
  if ((long long)total * 4 != shared_bytes) return cudaErrorInvalidValue;
  lv->shared_floats = (uint32_t)total;
  return cudaSuccess;
}

// The second design's entry: checks its limits, builds the passes' levels
// and launches them.
cudaError_t launch_bwd_design(bool block, const float* pos, const float* table, const float* grad, float* d_table,
                              float* d_pos, long long n, int features, long long rows_per_level,
                              const LevelGeometry& g, const float* scales, unsigned private_mask,
                              long long shared_bytes, float* partial, int private_blocks, unsigned magic,
                              unsigned shift, uint32_t modulus, cudaStream_t s) {
  if ((features != 2 && features != 4) || (uint64_t)n * (uint64_t)g.num_levels >= (1ull << 31) ||
      (uint64_t)g.num_levels * (uint64_t)rows_per_level * kLanes >= (1ull << 32) || (uintptr_t)table % 16 != 0 ||
      (uintptr_t)d_table % 16 != 0)
    return cudaErrorInvalidValue;
  BwdLevels lv;
  const cudaError_t bad = make_bwd_levels(block, features, g, scales, d_table != nullptr, d_pos != nullptr,
                                          private_mask, shared_bytes, &lv);
  if (bad != cudaSuccess) return bad;
  if (lv.private_count > 0 && (partial == nullptr || private_blocks < 1 || (uintptr_t)partial % 16 != 0))
    return cudaErrorInvalidValue;
  // one private block per slab, each with at least one sample per thread
  const long long enough = (n + kPrivThreads - 1) / kPrivThreads;
  const uint32_t pb = (uint32_t)(private_blocks < enough ? private_blocks : enough);
  BwdArgs a;
  a.pos = pos;
  a.table = table;
  a.grad = grad;
  a.d_table = d_table;
  a.d_pos = d_pos;
  a.n = (uint32_t)n;
  a.num_levels = (uint32_t)g.num_levels;
  a.level_stride = (uint32_t)(rows_per_level * kLanes);
  a.modulus = {modulus, magic, shift};
  if (block)
    return features == 2 ? launch_bwd_lanes<2, true>(a, g, lv, partial, pb, s)
                         : launch_bwd_lanes<4, true>(a, g, lv, partial, pb, s);
  return features == 2 ? launch_bwd_lanes<2, false>(a, g, lv, partial, pb, s)
                       : launch_bwd_lanes<4, false>(a, g, lv, partial, pb, s);
}

// ---------------------------------------------------------------------------
// K3b and K1bb: the derivatives that the density-gradient normals take.
// One thread per (sample, level), levels fastest; a block of kThreads holds
// whole samples (kThreads / L of them), so each sample's position terms are
// summed over its levels, in level order, through shared memory, with no
// atomics. Sample and table indices fit 32 bits (the wrapper checks the
// lane kernels' limits: n * L < 2^31, a table of fewer than 2^32 floats);
// offsets into pos, grad and the outputs are 64-bit.
//
// The per-axis factors of the corner weights and their derivatives in the
// position x: the offset o = clip(x*res - i0, 0, 1) has do/dx = res inside
// the cell, res/2 on its faces (jnp.clip's max/min pair at a tie) and 0
// outside; its second derivative is 0. K3's factors are (1 - o, o); K1's
// are the same on an even axis and the coin's constant (upf, 1 - upf) on an
// odd one.
//
// What bounds them: the gathered corner values (K3b: eight F-float groups
// in up to eight 128-byte lines per stencil; K1bb: one 8F-float block) and,
// for K1bb's table gradient, one float atomic per (corner of nonzero
// weight, feature) on the levels of nonzero scale. The arithmetic is a few
// dozen flops per gathered float. A simple first design: one thread per
// stencil, scalar loads.

__device__ __forceinline__ void axis_slope_cell(float p, int res, int* i0, float* o, float* slope) {
  const float s = __fmul_rn(p, (float)res);
  int c = (int)floorf(s);
  c = min(max(c, 0), res - 1);
  *i0 = c;
  const float t = __fsub_rn(s, (float)c);
  *o = fminf(fmaxf(t, 0.0f), 1.0f);
  *slope = (t > 0.0f && t < 1.0f) ? (float)res : (t == 0.0f || t == 1.0f) ? 0.5f * (float)res : 0.0f;
}

// Sum the threads' three position terms over each sample's L levels (the
// block holds whole samples: threads [L*k, L*k + L) are sample k's levels)
// and store them, in level order.
__device__ __forceinline__ void store_sample_sums(float (*part)[3], const float dp[3], int L, bool live, bool first,
                                                  float* d_pos, uint32_t i) {
#pragma unroll
  for (int a = 0; a < 3; ++a) part[threadIdx.x][a] = dp[a];
  __syncthreads();
  if (live && first && d_pos != nullptr) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float acc = part[threadIdx.x][a];
      for (int k = 1; k < L; ++k) acc = __fadd_rn(acc, part[threadIdx.x + k][a]);
      d_pos[3 * (int64_t)i + a] = acc;
    }
  }
}

// K3b. d_pos[i] = sum over levels and axes of slope * d_o, with
// d_o[a] = sum_c (+-1) (the other two axes' factors) * a_c and
// a_c = sum_f g[l*F+f] * bf16(corner c's value f).
template <int F>
__global__ void __launch_bounds__(kThreads)
    block_exact_bwd_kernel(const float* __restrict__ pos, const float* __restrict__ table,
                           const float* __restrict__ grad, float* __restrict__ d_pos, uint32_t n,
                           uint32_t level_stride, uint32_t nblocks, LevelGeometry g) {
  constexpr int kBlocksPerRow = kLanes / (8 * F);
  __shared__ float part[kThreads][3];
  const int L = g.num_levels;
  const int per_block = (kThreads / L) * L;
  const uint32_t t = blockIdx.x * (uint32_t)per_block + threadIdx.x;
  const bool live = (int)threadIdx.x < per_block && t < n * (uint32_t)L;
  const uint32_t i = live ? t / (uint32_t)L : 0u;
  const int l = live ? (int)(t - i * (uint32_t)L) : 0;
  float dp[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    const int res = g.res[l];
    int i0[3];
    float w[3][2], slope[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float o;
      axis_slope_cell(__ldg(pos + 3 * (int64_t)i + a), res, &i0[a], &o, &slope[a]);
      w[a][0] = __fsub_rn(1.0f, o);
      w[a][1] = o;
    }
    float gl[F];
#pragma unroll
    for (int f = 0; f < F; ++f) gl[f] = __ldg(grad + ((int64_t)i * L + l) * F + f);
    const float* level_table = table + (uint32_t)l * level_stride;
    float d_o[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int d[3] = {(c >> 2) & 1, (c >> 1) & 1, c & 1};
      const int vx = i0[0] + d[0], vy = i0[1] + d[1], vz = i0[2] + d[2];
      const uint32_t blk = block_index(vx >> 1, vy >> 1, vz >> 1, g.blocks_per_axis[l], g.dense[l], nblocks);
      const int parity = ((vx & 1) << 2) | ((vy & 1) << 1) | (vz & 1);
      const float* src = level_table + (blk / kBlocksPerRow) * kLanes + (blk % kBlocksPerRow) * 8 * F + parity * F;
      float a_c = 0.0f;
#pragma unroll
      for (int f = 0; f < F; ++f) a_c = __fadd_rn(a_c, __fmul_rn(gl[f], bf16_round(__ldg(src + f))));
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const int b1 = a == 0 ? 1 : 0, b2 = a == 2 ? 1 : 2;  // the other two axes
        const float term = __fmul_rn(__fmul_rn(a_c, w[b1][d[b1]]), w[b2][d[b2]]);
        d_o[a] = d[a] ? __fadd_rn(d_o[a], term) : __fsub_rn(d_o[a], term);
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) dp[a] = __fmul_rn(d_o[a], slope[a]);
  }
  store_sample_sums(part, dp, L, live, l == 0, d_pos, i);
}

// K1bb. For the cotangent u (n, 3) of K1 backward's position gradient,
// per (sample, level), with h_c = u . grad w8_c and a_c = sum_f g_f v_cf
// (v the bf16-rounded values of the sample's block):
//   d_grad[l*F+f] = sum_c h_c v_cf                   (K1's forward, weights h)
//   d_table[lane(c, f)] += scale[l] * h_c * g_f      (K1's scatter, weights h)
//   d_pos += sum_c a_c (hess w8_c) u                 (the mixed partials only)
// Each output is skipped when its pointer is null. d_table is float32 and
// zeroed by the caller; its atomics skip a corner of h_c = 0 and a level of
// scale 0 (outside bwd_levels), as K1's backward does.
template <int F>
__global__ void __launch_bounds__(kThreads)
    block_bwd_bwd_kernel(const float* __restrict__ pos, const float* __restrict__ table,
                         const float* __restrict__ grad, const float* __restrict__ u, float* __restrict__ d_grad,
                         float* __restrict__ d_table, float* __restrict__ d_pos, uint32_t n, uint32_t level_stride,
                         uint32_t nblocks, LevelGeometry g, LevelScales sc) {
  constexpr int kBlocksPerRow = kLanes / (8 * F);
  __shared__ float part[kThreads][3];
  const int L = g.num_levels;
  const int per_block = (kThreads / L) * L;
  const uint32_t t = blockIdx.x * (uint32_t)per_block + threadIdx.x;
  const bool live = (int)threadIdx.x < per_block && t < n * (uint32_t)L;
  const uint32_t i = live ? t / (uint32_t)L : 0u;
  const int l = live ? (int)(t - i * (uint32_t)L) : 0;
  float dp[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    const int res = g.res[l];
    float w[3][2], dw[3][2];
    int bc[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      int i0;
      float o, slope;
      axis_slope_cell(__ldg(pos + 3 * (int64_t)i + a), res, &i0, &o, &slope);
      const bool odd = (i0 & 1) == 1;
      const bool up = u01_hash(o, kCoinPrimes[a][0], kCoinPrimes[a][1]) < o;
      bc[a] = (i0 + ((odd && up) ? 1 : 0)) >> 1;
      const float upf = up ? 1.0f : 0.0f;
      w[a][0] = odd ? upf : __fsub_rn(1.0f, o);
      w[a][1] = odd ? __fsub_rn(1.0f, upf) : o;
      dw[a][0] = odd ? 0.0f : -slope;
      dw[a][1] = odd ? 0.0f : slope;
    }
    const uint32_t blk = block_index(bc[0], bc[1], bc[2], g.blocks_per_axis[l], g.dense[l], nblocks);
    const uint32_t off = (uint32_t)l * level_stride + (blk / kBlocksPerRow) * kLanes + (blk % kBlocksPerRow) * 8 * F;
    const int64_t row = ((int64_t)i * L + l) * F;
    float gl[F], dg[F];
#pragma unroll
    for (int f = 0; f < F; ++f) {
      gl[f] = __ldg(grad + row + f);
      dg[f] = 0.0f;
    }
    const float* ui = u + 3 * (int64_t)i;
    const float u0 = __ldg(ui), u1 = __ldg(ui + 1), u2 = __ldg(ui + 2);
    const float scale = d_table != nullptr ? sc.scale[l] : 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int bx = (c >> 2) & 1, by = (c >> 1) & 1, bz = c & 1;
      const float px = w[0][bx], py = w[1][by], pz = w[2][bz];
      const float dx = dw[0][bx], dy = dw[1][by], dz = dw[2][bz];
      // h_c = u . grad w8_c
      float h = __fmul_rn(__fmul_rn(__fmul_rn(u0, dx), py), pz);
      h = __fadd_rn(h, __fmul_rn(__fmul_rn(__fmul_rn(u1, px), dy), pz));
      h = __fadd_rn(h, __fmul_rn(__fmul_rn(__fmul_rn(u2, px), py), dz));
      float v[F];
      float a_c = 0.0f;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        v[f] = bf16_round(__ldg(table + off + c * F + f));
        a_c = __fadd_rn(a_c, __fmul_rn(gl[f], v[f]));
        dg[f] = __fadd_rn(dg[f], __fmul_rn(h, v[f]));
      }
      if (scale != 0.0f && h != 0.0f) {
#pragma unroll
        for (int f = 0; f < F; ++f) atomicAdd(d_table + off + c * F + f, __fmul_rn(__fmul_rn(scale, h), gl[f]));
      }
      // (hess w8_c) u: d2 w8_c / dx_a dx_b = dw_a dw_b (the third factor)
      dp[0] = __fadd_rn(dp[0], __fmul_rn(a_c, __fmul_rn(dx, __fadd_rn(__fmul_rn(__fmul_rn(dy, pz), u1),
                                                                     __fmul_rn(__fmul_rn(py, dz), u2)))));
      dp[1] = __fadd_rn(dp[1], __fmul_rn(a_c, __fmul_rn(dy, __fadd_rn(__fmul_rn(__fmul_rn(dx, pz), u0),
                                                                     __fmul_rn(__fmul_rn(px, dz), u2)))));
      dp[2] = __fadd_rn(dp[2], __fmul_rn(a_c, __fmul_rn(dz, __fadd_rn(__fmul_rn(__fmul_rn(dx, py), u0),
                                                                     __fmul_rn(__fmul_rn(px, dy), u1)))));
    }
    if (d_grad != nullptr) {
#pragma unroll
      for (int f = 0; f < F; ++f) d_grad[row + f] = dg[f];
    }
  }
  store_sample_sums(part, dp, L, live, l == 0, d_pos, i);
}

// One block per kThreads / L samples.
template <int F>
cudaError_t launch_normals_kernel(bool bwd_bwd, const float* pos, const float* table, const float* grad,
                                  const float* u, float* d_grad, float* d_table, float* d_pos, uint32_t n,
                                  uint32_t level_stride, uint32_t nblocks, const LevelGeometry& g,
                                  const LevelScales& sc, cudaStream_t s) {
  const uint32_t per_block = (uint32_t)(kThreads / g.num_levels);
  const uint32_t grid = (n + per_block - 1) / per_block;
  if (bwd_bwd)
    block_bwd_bwd_kernel<F><<<grid, kThreads, 0, s>>>(pos, table, grad, u, d_grad, d_table, d_pos, n, level_stride,
                                                      nblocks, g, sc);
  else
    block_exact_bwd_kernel<F><<<grid, kThreads, 0, s>>>(pos, table, grad, d_pos, n, level_stride, nblocks, g);
  return cudaGetLastError();
}

// The shared entry of K3b and K1bb: checks the 32-bit limits and the width.
cudaError_t launch_normals(bool bwd_bwd, const float* pos, const float* table, const float* grad, const float* u,
                           float* d_grad, float* d_table, float* d_pos, long long n, int features,
                           long long rows_per_level, long long hash_table_size, const LevelGeometry& g,
                           const float* scales, cudaStream_t s) {
  if ((uint64_t)n * (uint64_t)g.num_levels >= (1ull << 31) ||
      (uint64_t)g.num_levels * (uint64_t)rows_per_level * kLanes >= (1ull << 32))
    return cudaErrorInvalidValue;
  LevelScales sc;
  for (int l = 0; l < g.num_levels; ++l) sc.scale[l] = scales != nullptr ? scales[l] : 0.0f;
  const uint32_t stride = (uint32_t)(rows_per_level * kLanes), nb = (uint32_t)(hash_table_size / 8);
  switch (features) {
    case 1: return launch_normals_kernel<1>(bwd_bwd, pos, table, grad, u, d_grad, d_table, d_pos, (uint32_t)n, stride, nb, g, sc, s);
    case 2: return launch_normals_kernel<2>(bwd_bwd, pos, table, grad, u, d_grad, d_table, d_pos, (uint32_t)n, stride, nb, g, sc, s);
    case 4: return launch_normals_kernel<4>(bwd_bwd, pos, table, grad, u, d_grad, d_table, d_pos, (uint32_t)n, stride, nb, g, sc, s);
    case 8: return launch_normals_kernel<8>(bwd_bwd, pos, table, grad, u, d_grad, d_table, d_pos, (uint32_t)n, stride, nb, g, sc, s);
    case 16: return launch_normals_kernel<16>(bwd_bwd, pos, table, grad, u, d_grad, d_table, d_pos, (uint32_t)n, stride, nb, g, sc, s);
    default: return cudaErrorInvalidValue;
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

// K7's forward in lane groups: one block of 32 * levels threads per
// kFlatSamples samples, its output rows in dynamic shared memory (128 *
// levels * F bytes, at most 16 KB).
template <int F>
cudaError_t launch_flat_lanes(const LaneArgs& a, const LevelGeometry& g, cudaStream_t s) {
  const uint32_t grid = (a.n + kFlatSamples - 1) / kFlatSamples;
  flat_lanes_kernel<F><<<grid, 32 * a.levels.d, kFlatSamples * a.levels.d * F * 4, s>>>(a, g);
  return cudaGetLastError();
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

// The flat levels in the block geometry's record (blocks_per_axis unused),
// which the lane kernels take.
LevelGeometry level_geometry_of(const FlatGeometry& g) {
  LevelGeometry lg;
  lg.num_levels = g.num_levels;
  for (int l = 0; l < g.num_levels; ++l) {
    lg.res[l] = g.res[l];
    lg.blocks_per_axis[l] = 0;
    lg.dense[l] = g.dense[l];
  }
  return lg;
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
  a.modulus = {nblocks, block_magic, block_shift};
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
// design 0 takes block_encode_bwd_kernel; 1 the lane groups (F = 2 or 4,
// the lane kernels' 32-bit limits, table and d_table 16-byte aligned) with
// the divisor (magic, shift) of T/8. Returns a cudaError_t (0 on success).
int nst_hash_encode_block_bwd(const void* pos, const void* table, const void* grad,
                              void* d_table, void* d_pos, long long n, int num_levels,
                              int features_per_level, long long rows_per_level,
                              long long hash_table_size, const int* resolutions,
                              const float* scales, int design, unsigned block_magic, unsigned block_shift,
                              void* stream) {
  LevelGeometry g;
  const cudaError_t bad = make_geometry(n, num_levels, rows_per_level, hash_table_size, resolutions, &g);
  if (bad != cudaSuccess) return (int)bad;
  if (design != 0 && design != 1) return (int)cudaErrorInvalidValue;
  if (n == 0 || (d_table == nullptr && d_pos == nullptr)) return (int)cudaSuccess;
  const uint32_t nblocks = (uint32_t)(hash_table_size / 8);
  const cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)pos;
  const float* tab = (const float*)table;
  const float* gr = (const float*)grad;
  float* dt = (float*)d_table;
  float* dp = (float*)d_pos;
  if (design == 1)
    return (int)launch_bwd_design(true, p, tab, gr, dt, dp, n, features_per_level, rows_per_level, g, scales, 0,
                                  0, nullptr, 0, block_magic, block_shift, nblocks, s);
  LevelScales sc;
  for (int l = 0; l < num_levels; ++l) sc.scale[l] = scales[l];
  const unsigned int grid = (unsigned int)((n + kThreads - 1) / kThreads);
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
// device pointers; resolutions is a host array of num_levels ints. design
// 0 takes flat_encode_kernel (one thread per (sample, level)); 1 the lane
// groups (F = 2 or 4, a 16-byte aligned table of fewer than 2^32 floats,
// n * num_levels < 2^31) with the divisors (magic, shift) of the level
// count and of hash_table_size from hash_grid._u32_divisor. Returns a
// cudaError_t (0 on success).
int nst_hash_encode_flat(const void* pos, const void* table, void* out, long long n, int num_levels,
                         int features_per_level, long long rows_per_level, long long hash_table_size,
                         const int* resolutions, int design, unsigned level_magic, unsigned level_shift,
                         unsigned magic, unsigned shift, void* stream) {
  FlatGeometry g;
  const cudaError_t bad = make_flat_geometry(n, num_levels, rows_per_level, hash_table_size, resolutions, &g);
  if (bad != cudaSuccess) return (int)bad;
  if (design != 0 && design != 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)pos;
  const float* tab = (const float*)table;
  float* o = (float*)out;
  if (design == 1) {
    if ((features_per_level != 2 && features_per_level != 4) || (uint64_t)n * (uint64_t)num_levels >= (1ull << 31) ||
        (uint64_t)num_levels * (uint64_t)rows_per_level * kLanes >= (1ull << 32) || (uintptr_t)table % 16 != 0)
      return (int)cudaErrorInvalidValue;
    LaneArgs a;
    a.pos = p;
    a.table = tab;
    a.out = o;
    a.n = (uint32_t)n;
    a.level_stride = (uint32_t)(rows_per_level * kLanes);
    a.levels = {(uint32_t)num_levels, level_magic, level_shift};
    a.modulus = {(uint32_t)hash_table_size, magic, shift};
    const LevelGeometry lg = level_geometry_of(g);
    return (int)(features_per_level == 2 ? launch_flat_lanes<2>(a, lg, s) : launch_flat_lanes<4>(a, lg, s));
  }
  const unsigned int grid = (unsigned int)((n * num_levels + kThreads - 1) / kThreads);
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
// gradient. Either may be null to skip it. design 0 takes
// flat_encode_bwd_kernel (private_mask 0, shared_bytes 0); 1 the second
// design (F = 2 or 4, the lane kernels' 32-bit limits, table and d_table
// 16-byte aligned) with hash_grid.bwd_plan's privatised levels (a bit mask;
// only with d_table and without d_pos) and shared bytes, and the private
// pass's scratch `partial` of private_blocks slabs of shared_bytes each
// (16-byte aligned; null without privatised levels), one block per slab at
// most; (magic, shift) divide by hash_table_size. Returns a cudaError_t (0
// on success); cudaErrorInvalidValue for a plan the planner does not
// produce.
int nst_hash_encode_flat_bwd(const void* pos, const void* table, const void* grad, void* d_table,
                             void* d_pos, long long n, int num_levels, int features_per_level,
                             long long rows_per_level, long long hash_table_size, const int* resolutions,
                             int design, unsigned private_mask, long long shared_bytes, void* partial,
                             int private_blocks, unsigned magic, unsigned shift, void* stream) {
  FlatGeometry g;
  const cudaError_t bad = make_flat_geometry(n, num_levels, rows_per_level, hash_table_size, resolutions, &g);
  if (bad != cudaSuccess) return (int)bad;
  if (design != 0 && design != 1) return (int)cudaErrorInvalidValue;
  if (design == 0 && (private_mask != 0 || shared_bytes != 0)) return (int)cudaErrorInvalidValue;
  if (n == 0 || (d_table == nullptr && d_pos == nullptr)) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* p = (const float*)pos;
  const float* tab = (const float*)table;
  const float* gr = (const float*)grad;
  float* dt = (float*)d_table;
  float* dp = (float*)d_pos;
  if (design == 1)
    return (int)launch_bwd_design(false, p, tab, gr, dt, dp, n, features_per_level, rows_per_level,
                                  level_geometry_of(g), nullptr,
                                  private_mask, shared_bytes, (float*)partial, private_blocks, magic, shift,
                                  (uint32_t)hash_table_size, s);
  const unsigned int grid = (unsigned int)((n + kThreads - 1) / kThreads);
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

// K3b: K3's position gradient. pos (n, 3), table (num_levels,
// rows_per_level, 128) and grad (n, num_levels * features_per_level) are
// f32 device inputs; d_pos (n, 3) receives the gradient. n * num_levels
// < 2^31 and a table of fewer than 2^32 floats. Returns a cudaError_t.
int nst_hash_encode_block_exact_bwd(const void* pos, const void* table, const void* grad, void* d_pos, long long n,
                                    int num_levels, int features_per_level, long long rows_per_level,
                                    long long hash_table_size, const int* resolutions, void* stream) {
  LevelGeometry g;
  const cudaError_t bad = make_geometry(n, num_levels, rows_per_level, hash_table_size, resolutions, &g);
  if (bad != cudaSuccess) return (int)bad;
  if (n == 0) return (int)cudaSuccess;
  return (int)launch_normals(false, (const float*)pos, (const float*)table, (const float*)grad, nullptr, nullptr,
                             nullptr, (float*)d_pos, n, features_per_level, rows_per_level, hash_table_size, g,
                             nullptr, (cudaStream_t)stream);
}

// K1bb: K1's backward differentiated again. pos, table and grad as for K1's
// backward; u (n, 3) is the cotangent of its position gradient. d_grad (n,
// num_levels * features_per_level) and d_pos (n, 3) are written; d_table,
// of the table's shape, must be zeroed by the caller and receives the
// table gradient times scales[l] (a host array of num_levels floats). Any
// output may be null to skip it. The limits of K3b. Returns a cudaError_t.
int nst_hash_encode_block_bwd_bwd(const void* pos, const void* table, const void* grad, const void* u, void* d_grad,
                                  void* d_table, void* d_pos, long long n, int num_levels, int features_per_level,
                                  long long rows_per_level, long long hash_table_size, const int* resolutions,
                                  const float* scales, void* stream) {
  LevelGeometry g;
  const cudaError_t bad = make_geometry(n, num_levels, rows_per_level, hash_table_size, resolutions, &g);
  if (bad != cudaSuccess) return (int)bad;
  if (n == 0 || (d_grad == nullptr && d_table == nullptr && d_pos == nullptr)) return (int)cudaSuccess;
  return (int)launch_normals(true, (const float*)pos, (const float*)table, (const float*)grad, (const float*)u,
                             (float*)d_grad, (float*)d_table, (float*)d_pos, n, features_per_level, rows_per_level,
                             hash_table_size, g, scales, (cudaStream_t)stream);
}

const char* nst_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
