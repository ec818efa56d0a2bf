// The hash-table gather probes, for Hopper (sm_90a). Plain C interface,
// loaded with ctypes by nerfstudio_torch/ops/gather_probes.py.
//
// Replaces the Pallas probes of the JAX package's exp/ directory (each
// gathered from a table held whole in the TPU's VMEM):
//   * row_gather_kernel: exp/pallas_gather2.py stage1 (g1_kernel), a
//     whole-row gather out[i, :] = table[rows[i], :];
//   * lane_gather_smem_kernel and lane_gather_kernel: exp/pallas_gather3.py
//     run_case (its nested kernel), out[i, j] = table[rows[i, j], j], and
//     exp/gather_bench.py f4 (gather_kernel), the same with rows[i, j] mod S
//     (Python's modulo);
//   * gather_select_rows_kernel (the default) and gather_select_kernel:
//     exp/pallas_gather.py fused_gather (kernel) and exp/pallas_gather2.py
//     stage2 (g2_kernel), a row gather per corner, a lane select and an
//     8-corner weighted sum: fused_gather broadcasts the entry's F values
//     to all 128 lanes (lane l reads slot*F + l%F), stage2 keeps the lanes
//     of the entry (l/F == slot) and zeroes the rest.
//
// Tables are (rows, 128) of float32 or bfloat16 (elem_bytes 4 or 2);
// indices are int32; weights float32; sums float32 in the probes' order.
// An index outside the table is clamped to its nearest row (and a slot to
// the row's last entry), as XLA's gather clamps: no kernel reads past the
// table whatever its inputs.
//
// What bounds them: bytes. Every output element is written once and the
// indices read once; a gathered table row is 512 B (256 B in bf16) that
// stays in L2 at the probes' table sizes (8 MB at most, against 50 MB). So
// the write of the output and the index reads set the bound.
//   * row_gather_kernel follows the output: consecutive threads write
//     consecutive 16-byte vectors, so stores coalesce; the table reads hit
//     L2.
//   * The gather-select writes a 512-byte float32 row per sample (134 MB at
//     the probes' shapes) from 8 corners' indices (25 MB) and 16 bytes of
//     the table per corner. One thread per output element
//     (gather_select_kernel) repeated each sample's index loads and
//     address arithmetic, with 64-bit and runtime divisions, in all 128
//     threads of the sample, and took ~12x the bytes' time on the H100
//     (chip_smoke.py phase 33). gather_select_rows_kernel (below) does a
//     sample's work once, in one lane, and writes rows as whole-warp float4
//     streaming stores; at the probes' shape its walk over a group's rows
//     is one shared-memory read and one store per row.
//   * The per-lane gather cannot read the table that way: lane j of a warp
//     reads 4 bytes of a random row, one 32-byte L2 sector per element, so
//     the one-thread-per-element lane_gather_kernel moves 8x (f32) the
//     useful bytes through L2. lane_gather_smem_kernel keeps the table on
//     chip as the Pallas kernel kept it in VMEM: a block copies the columns
//     [l0, l0 + k) of the table into shared memory (column-major, up to the
//     227 KB a block may take) and then streams its rows, reading
//     rows[i, l0:l0+k] and writing out[i, l0:l0+k] as contiguous vectors
//     and looking every index up in shared memory. k, the lanes per block,
//     is the largest power of two dividing 128 whose columns fit
//     (gather_probes._lane_plan); a table whose one column does not fit,
//     or whose k lanes are less than a 32-byte sector, takes
//     lane_gather_kernel (see below). Blocks of one row range (the k-lane groups)
//     sit next to each other in the grid and run together, so an index
//     sector that several groups share is fetched from HBM once. The grid
//     is one wave of blocks; each block loops over its row tiles.
//   * Writing is what bounds it on this card. Row segments written with
//     plain stores ran at a fraction of the write rate; streaming stores
//     (st.global.cs) run near it where a block writes whole 32-byte sectors
//     (f4, 8 lanes; the 512-row table, 64). Where the k lanes are less than
//     a sector (the 16384-row table of run_case, k = 2: 8 bytes) four SMs
//     write each sector in pieces, and the kernel is slower than
//     lane_gather_kernel (chip_smoke.py times both), so _lane_plan sends
//     such tables to lane_gather_kernel. Clusters that shared
//     their columns through distributed shared memory, so that each block
//     read and wrote whole sectors, were no faster.
//   * f4's modulo runs in 32 bits: a multiply-high by a precomputed magic
//     number (gather_probes._divisor_magic) instead of a 64-bit division.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;
constexpr int kGatherThreads = 1024;    // lane_gather_smem_kernel's block
constexpr int kIndicesPerThread = 16;   // loaded before the first lookup
constexpr int kMaxSharedBytes = 232448; // 227 KB, a block's opt-in maximum

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(unsigned short v) { return __uint_as_float(((unsigned int)v) << 16); }

__device__ __forceinline__ int64_t clamp_row(int64_t r, int64_t table_rows) {
  return r < 0 ? 0 : (r >= table_rows ? table_rows - 1 : r);
}

__device__ __forceinline__ int clamp_row32(int r, int table_rows) {
  return r < 0 ? 0 : (r >= table_rows ? table_rows - 1 : r);
}

// Python's r mod s for every int32 r, 1 <= s < 2^31. For 0 <= x < 2^31,
// x / s = umulhi(x, magic) >> shift (magic = ceil(2^(31+l) / s), l =
// ceil(log2 s), shift = l - 1); a negative r maps to x = -r - 1 = ~r, and
// r mod s = s - 1 - (x mod s).
struct Divisor {
  int s;
  unsigned int magic;
  int shift;
};

__device__ __forceinline__ int py_mod(int r, const Divisor& d) {
  if (d.s == 1) return 0;
  const unsigned int x = r >= 0 ? (unsigned int)r : ~(unsigned int)r;
  const unsigned int rem = x - (__umulhi(x, d.magic) >> d.shift) * (unsigned int)d.s;
  return r >= 0 ? (int)rem : d.s - 1 - (int)rem;
}

template <bool kModulo>
__device__ __forceinline__ int lane_row(int r, int table_rows, const Divisor& d) {
  return kModulo ? py_mod(r, d) : clamp_row32(r, table_rows);
}

// V values of T moved as one aligned load or store.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// One thread per 16-byte vector of the output.
__global__ void __launch_bounds__(kThreads)
    row_gather_kernel(const uint4* __restrict__ table, const int* __restrict__ rows, uint4* __restrict__ out,
                      int64_t total, int vectors_per_row, int64_t table_rows) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int64_t i = t / vectors_per_row;
  const int v = (int)(t - i * vectors_per_row);
  out[t] = __ldg(table + clamp_row(__ldg(rows + i), table_rows) * vectors_per_row + v);
}

// One thread per output element, the table read through L2: the path of a
// table whose single column does not fit in shared memory.
template <typename T, bool kModulo>
__global__ void __launch_bounds__(kThreads)
    lane_gather_kernel(const T* __restrict__ table, const int* __restrict__ rows, T* __restrict__ out,
                       int64_t total, int table_rows, Divisor div) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int r = lane_row<kModulo>(__ldg(rows + t), table_rows, div);
  out[t] = table[(int64_t)r * kLanes + (t & (kLanes - 1))];
}

// A store that streams past the caches (st.global.cs): measured on the
// H100, plain stores of this kernel's strided row segments ran at a
// fraction of the card's write rate.
template <typename P>
__device__ __forceinline__ void store_streaming(P* dst, const P& v) {
  if constexpr (sizeof(P) == 16) __stcs(reinterpret_cast<uint4*>(dst), *reinterpret_cast<const uint4*>(&v));
  else if constexpr (sizeof(P) == 8) __stcs(reinterpret_cast<uint2*>(dst), *reinterpret_cast<const uint2*>(&v));
  else if constexpr (sizeof(P) == 4)
    __stcs(reinterpret_cast<unsigned int*>(dst), *reinterpret_cast<const unsigned int*>(&v));
  else __stcs(reinterpret_cast<unsigned short*>(dst), *reinterpret_cast<const unsigned short*>(&v));
}

// Block (g, y): lanes [g*k, g*k + k) of the row tiles y, y + gridDim.y, ...
// of rows_per_tile rows each. A thread moves V lanes of one row at a time
// (V = min(k, 4)), always the same V lanes (c .. c + V - 1 of the group's);
// a row holds k / V = 1 << vpr_shift such vectors.
template <typename T, int V, bool kModulo>
__global__ void __launch_bounds__(kGatherThreads, 1)
    lane_gather_smem_kernel(const T* __restrict__ table, const int* __restrict__ rows, T* __restrict__ out,
                            int64_t m, int table_rows, int vpr_shift, Divisor div) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cols = reinterpret_cast<T*>(smem_raw);
  const int vpr = 1 << vpr_shift;
  const int l0 = blockIdx.x * (vpr * V);
  // the group's columns, V lanes of a row per load
  for (int u = threadIdx.x; u < table_rows * vpr; u += kGatherThreads) {
    const int r = u >> vpr_shift, c = (u & (vpr - 1)) * V;
    const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(table + (int64_t)r * kLanes + l0 + c);
#pragma unroll
    for (int e = 0; e < V; ++e) cols[(c + e) * table_rows + r] = p.v[e];
  }
  __syncthreads();

  const int c = (threadIdx.x & (vpr - 1)) * V;
  constexpr int U = kIndicesPerThread / V;
  const int64_t rows_per_tile = (int64_t)(kGatherThreads * U) >> vpr_shift;
  for (int64_t base = blockIdx.y * rows_per_tile; base < m; base += gridDim.y * rows_per_tile) {
    Pack<int, V> idx[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // every index load in flight before the first lookup
      const int64_t i = base + ((u * kGatherThreads + (int)threadIdx.x) >> vpr_shift);
      if (i < m) idx[u] = *reinterpret_cast<const Pack<int, V>*>(rows + i * kLanes + l0 + c);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t i = base + ((u * kGatherThreads + (int)threadIdx.x) >> vpr_shift);
      if (i < m) {
        Pack<T, V> o;
#pragma unroll
        for (int e = 0; e < V; ++e)
          o.v[e] = cols[(c + e) * table_rows + lane_row<kModulo>(idx[u].v[e], table_rows, div)];
        store_streaming(reinterpret_cast<Pack<T, V>*>(out + i * kLanes + l0 + c), o);
      }
    }
  }
}

// One warp per output row: the gather-select in rows (the default design,
// gather_select_rows_kernel). A warp takes 32 samples at a time (a group),
// lane j serving sample j while staging; the warp then writes the group's
// 32 rows, lane l owning output lanes 4l .. 4l+3, each row one coalesced
// 512-byte warp store of float4 streaming stores (__stcs).
//   * The probes' shape (F = 4, 8 corners; kSums): lane j computes its own
//     sample's sums while staging, in the probes' float32 operations and
//     order, and the warp only reads them back and stores.
//       - broadcast (fused_gather): the row is one float4, the sum over the
//         corners of table[row, clamp(slot)*4 .. +3] * w, repeated 32 times.
//       - masked (stage2): output group l sums, from zero, (l == slot_c ?
//         v_c * w_c : 0 * w_c) over the corners. Every group that no corner
//         selects holds the same value b, the sum of the 0 * w_c (0, or NaN
//         where a weight is NaN or infinite, as in the twin); lane j stages
//         b, the sum of each group its corners select (at most 8, kept at
//         the first corner that selects it) and a byte map group -> corner.
//     The table is read as one 16-byte (bf16: 8-byte) vector per corner and
//     sample. The grid is one wave of blocks whose warps stride over the
//     groups, each loading its next group's indices before it sums and
//     stores the current one, so that index reads overlap the writes.
//   * Any other F (a power of two dividing 128) or corner count walks per
//     lane: lane j stages per corner {table offset, slot, weight bits}, and
//     for each sample every lane reads each corner's entry back (a
//     broadcast 16-byte shared load) and loads, per output element, the
//     value it selects (shifts and masks by log2 F, scalar loads).
// Sums as gather_select_kernel's (__fmul_rn, __fadd_rn, no contraction), so
// the two designs are bit-equal for every input. Offsets into the indices
// and the table are 32-bit (the wrapper keeps them below 2^31); only the
// final addresses are 64-bit.
constexpr int kGroup = 32;  // samples per pass of a warp, one per lane while staging
constexpr int kRowsWarps = 4;
constexpr int kSumsCorners = 8;
constexpr unsigned char kNoSlot = 0xff;

__device__ __forceinline__ float4 load4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
__device__ __forceinline__ float4 load4(const unsigned short* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u), __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float4 weighted(float4 v, float wc) {
  return make_float4(__fmul_rn(v.x, wc), __fmul_rn(v.y, wc), __fmul_rn(v.z, wc), __fmul_rn(v.w, wc));
}

__device__ __forceinline__ float4 add4(float4 a, float4 t) {
  return make_float4(__fadd_rn(a.x, t.x), __fadd_rn(a.y, t.y), __fadd_rn(a.z, t.z), __fadd_rn(a.w, t.w));
}

// One sample's indices and weights as loaded (clamped where used).
struct SampleInputs {
  int row[kSumsCorners];
  int slot[kSumsCorners];
  float w[kSumsCorners];
};

__device__ __forceinline__ void load_sample(SampleInputs& x, const int* __restrict__ rows,
                                            const int* __restrict__ slots, const float* __restrict__ w, int n, int k,
                                            int block, int block_stride, int corner_stride) {
  if (k >= n) return;
  const unsigned q = (unsigned)k / (unsigned)block;
  const int base = (int)(q * (unsigned)block_stride + ((unsigned)k - q * (unsigned)block));
#pragma unroll
  for (int c = 0; c < kSumsCorners; ++c) {
    const int o = base + c * corner_stride;
    x.row[c] = __ldg(rows + o);
    x.slot[c] = __ldg(slots + o);
    x.w[c] = __ldg(w + o);
  }
}

// Stage lane `lane`'s sample: broadcast sums[lane]; masked sums[lane * 8 +
// c], background[lane] and slot_of[lane * 32 + group].
template <typename T, bool kMasked>
__device__ __forceinline__ void stage_sums(const SampleInputs& x, const T* __restrict__ table, int table_rows,
                                           int lane, float4* sums, float* background, unsigned char* slot_of) {
  if constexpr (!kMasked) {
    float4 acc;
#pragma unroll
    for (int c = 0; c < kSumsCorners; ++c) {  // corner 0 assigns
      const int off = clamp_row32(x.row[c], table_rows) * kLanes + min(max(x.slot[c], 0), kLanes / 4 - 1) * 4;
      const float4 t = weighted(load4(table + off), x.w[c]);
      acc = c == 0 ? t : add4(acc, t);
    }
    sums[lane] = acc;
  } else {
    int sel[kSumsCorners];  // the output group corner c selects, or -1
    float4 t[kSumsCorners];
    float z[kSumsCorners];
#pragma unroll
    for (int c = 0; c < kSumsCorners; ++c) {
      sel[c] = (unsigned)x.slot[c] < (unsigned)(kLanes / 4) ? x.slot[c] : -1;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (sel[c] >= 0) v = load4(table + clamp_row32(x.row[c], table_rows) * kLanes + 4 * sel[c]);
      t[c] = weighted(v, x.w[c]);
      z[c] = __fmul_rn(0.0f, x.w[c]);
    }
    float b = 0.0f;
#pragma unroll
    for (int c = 0; c < kSumsCorners; ++c) b = __fadd_rn(b, z[c]);
    background[lane] = b;
    uint4* map = reinterpret_cast<uint4*>(slot_of + lane * 32);
    map[0] = map[1] = make_uint4(~0u, ~0u, ~0u, ~0u);
#pragma unroll
    for (int c = 0; c < kSumsCorners; ++c) {
      bool first = sel[c] >= 0;
#pragma unroll
      for (int d = 0; d < c; ++d) first = first && sel[d] != sel[c];
      if (first) {
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int d = 0; d < kSumsCorners; ++d)
          acc = add4(acc, sel[d] == sel[c] ? t[d] : make_float4(z[d], z[d], z[d], z[d]));
        sums[lane * kSumsCorners + c] = acc;
        slot_of[lane * 32 + sel[c]] = (unsigned char)c;
      }
    }
  }
}

// The per-lane walk's values for lane l's four outputs 4l+i at one corner:
// e = {table offset, slot, weight bits}. Masked: 0 where the output's entry
// is not the slot.
template <typename T, bool kMasked>
__device__ __forceinline__ float4 corner_values(const T* __restrict__ table, const int4 e, int lane, int log2f) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float* vv = &v.x;
  const int fmask = (1 << log2f) - 1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = 4 * lane + i;
    if (!kMasked) vv[i] = to_f32(__ldg(table + e.x + (m & fmask)));
    else if ((m >> log2f) == e.y) vv[i] = to_f32(__ldg(table + e.x + m));
  }
  return v;
}

template <typename T, bool kMasked, bool kSums>
__global__ void __launch_bounds__(kRowsWarps * 32)
    gather_select_rows_kernel(const T* __restrict__ table, const int* __restrict__ rows,
                              const int* __restrict__ slots, const float* __restrict__ w, float* __restrict__ out,
                              int n, int table_rows, int log2f, int block, int block_stride, int corner_stride,
                              int corners) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = (n + kGroup - 1) / kGroup;
  const int stride = gridDim.x * kRowsWarps;
  auto store = [&](int k0, int s, float4 v) {
    __stcs(reinterpret_cast<float4*>(out + (int64_t)(k0 + s) * kLanes + 4 * lane), v);
  };
  if constexpr (kSums) {
    // per warp: 32 x 8 sums, 32 background values, a 32 x 32 byte map
    float4* sums = reinterpret_cast<float4*>(smem_raw) + warp * kGroup * kSumsCorners;
    float* background =
        reinterpret_cast<float*>(reinterpret_cast<float4*>(smem_raw) + kRowsWarps * kGroup * kSumsCorners);
    unsigned char* slot_of = reinterpret_cast<unsigned char*>(background + kRowsWarps * kGroup) + warp * kGroup * 32;
    background += warp * kGroup;
    int g = blockIdx.x * kRowsWarps + warp;
    SampleInputs x;
    if (g < groups) load_sample(x, rows, slots, w, n, g * kGroup + lane, block, block_stride, corner_stride);
    for (; g < groups; g += stride) {
      const int k0 = g * kGroup;
      const int in_group = min(kGroup, n - k0);
      SampleInputs next;  // in flight while this group is summed and stored
      if (g + stride < groups)
        load_sample(next, rows, slots, w, n, (g + stride) * kGroup + lane, block, block_stride, corner_stride);
      __syncwarp();  // the last group's sums are read
      if (lane < in_group) stage_sums<T, kMasked>(x, table, table_rows, lane, sums, background, slot_of);
      __syncwarp();
      for (int s = 0; s < in_group; ++s) {
        if (!kMasked) {
          store(k0, s, sums[s]);
        } else {
          const unsigned char c = slot_of[s * 32 + lane];
          const float b = background[s];
          store(k0, s, c == kNoSlot ? make_float4(b, b, b, b) : sums[s * kSumsCorners + c]);
        }
      }
      x = next;
    }
  } else {
    int4* stage = reinterpret_cast<int4*>(smem_raw) + warp * corners * kGroup;  // corners x 32 entries per warp
    for (int g = blockIdx.x * kRowsWarps + warp; g < groups; g += stride) {
      const int k0 = g * kGroup;
      const int in_group = min(kGroup, n - k0);
      __syncwarp();  // the last group's entries are read
      if (lane < in_group) {
        const unsigned k = (unsigned)(k0 + lane), q = k / (unsigned)block;
        const int base = (int)(q * (unsigned)block_stride + (k - q * (unsigned)block));
#pragma unroll 8
        for (int c = 0; c < corners; ++c) {
          const int o = base + c * corner_stride;
          const int sl = __ldg(slots + o);
          int off = clamp_row32(__ldg(rows + o), table_rows) * kLanes;
          if (!kMasked) off += min(max(sl, 0), (kLanes >> log2f) - 1) << log2f;
          stage[c * kGroup + lane] = make_int4(off, sl, __float_as_int(__ldg(w + o)), 0);
        }
      }
      __syncwarp();
      for (int s = 0; s < in_group; ++s) {
        const int4 e0 = stage[s];
        const float4 t0 = weighted(corner_values<T, kMasked>(table, e0, lane, log2f), __int_as_float(e0.z));
        // masked sums from zero, broadcast assigns corner 0
        float4 acc = kMasked ? add4(make_float4(0.0f, 0.0f, 0.0f, 0.0f), t0) : t0;
#pragma unroll 7
        for (int c = 1; c < corners; ++c) {
          const int4 e = stage[c * kGroup + s];
          acc = add4(acc, weighted(corner_values<T, kMasked>(table, e, lane, log2f), __int_as_float(e.z)));
        }
        store(k0, s, acc);
      }
    }
  }
}

// One thread per output element (sample k, lane): the first design, kept
// for chip_smoke.py's comparison. Corner c of sample k
// sits at (k / block) * block_stride + c * corner_stride + k % block in
// rows, slots and w, which covers fused_gather's (corners, blocks, S) and
// stage2's (blocks, corners, BLK) layouts.
template <typename T, bool kMasked>
__global__ void __launch_bounds__(kThreads)
    gather_select_kernel(const T* __restrict__ table, const int* __restrict__ rows,
                         const int* __restrict__ slots, const float* __restrict__ w, float* __restrict__ out,
                         int64_t n, int64_t table_rows, int features, int64_t block, int64_t block_stride,
                         int64_t corner_stride, int corners) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * kLanes) return;
  const int64_t k = t / kLanes;
  const int lane = (int)(t - k * kLanes);
  const int64_t base = (k / block) * block_stride + k % block;
  float acc = 0.0f;
  for (int c = 0; c < corners; ++c) {
    const int64_t off = base + c * corner_stride;
    const int64_t row = clamp_row(__ldg(rows + off), table_rows);
    const int slot = __ldg(slots + off);
    const float wc = __ldg(w + off);
    if (kMasked) {
      // acc + where(lane's entry == slot, value, 0) * w, from acc = 0
      const float v = lane / features == slot ? to_f32(table[row * kLanes + lane]) : 0.0f;
      acc = __fadd_rn(acc, __fmul_rn(v, wc));
    } else {
      // the entry's F values repeated over the lanes; corner 0 assigns
      const int entry = min(max(slot, 0), kLanes / features - 1);
      const float term = __fmul_rn(to_f32(table[row * kLanes + entry * features + lane % features]), wc);
      acc = c == 0 ? term : __fadd_rn(acc, term);
    }
  }
  out[t] = acc;
}

unsigned int grid_for(int64_t total) { return (unsigned int)((total + kThreads - 1) / kThreads); }

// Launch lane_gather_smem_kernel<T, V, kModulo> over (128 / k) lane groups
// and as many row-tile chunks as fill one wave of the card.
template <typename T, int V, bool kModulo>
cudaError_t launch_smem(const void* table, const int* rows, void* out, int64_t m, int table_rows, int k,
                        Divisor div, cudaStream_t s) {
  auto kernel = lane_gather_smem_kernel<T, V, kModulo>;
  const size_t smem = (size_t)k * table_rows * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGatherThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int groups = kLanes / k;
  int vpr_shift = 0;
  while ((V << vpr_shift) < k) ++vpr_shift;
  const int64_t rows_per_tile = (int64_t)(kGatherThreads * (kIndicesPerThread / V)) >> vpr_shift;
  const int64_t tiles = (m + rows_per_tile - 1) / rows_per_tile;
  int64_t chunks = (int64_t)sms * per_sm / groups;
  chunks = chunks < 1 ? 1 : (chunks > tiles ? tiles : chunks);
  kernel<<<dim3(groups, (unsigned int)chunks), kGatherThreads, smem, s>>>(
      (const T*)table, rows, (T*)out, m, table_rows, vpr_shift, div);
  return cudaGetLastError();
}

template <typename T, bool kModulo>
cudaError_t launch_lane_gather(const void* table, const int* rows, void* out, int64_t m, int table_rows, int k,
                               Divisor div, cudaStream_t s) {
  if (k == 0) {
    const int64_t total = m * kLanes;
    lane_gather_kernel<T, kModulo><<<grid_for(total), kThreads, 0, s>>>((const T*)table, rows, (T*)out, total,
                                                                        table_rows, div);
    return cudaGetLastError();
  }
  if (k == 1) return launch_smem<T, 1, kModulo>(table, rows, out, m, table_rows, k, div, s);
  if (k == 2) return launch_smem<T, 2, kModulo>(table, rows, out, m, table_rows, k, div, s);
  return launch_smem<T, 4, kModulo>(table, rows, out, m, table_rows, k, div, s);
}

// Launch gather_select_rows_kernel as one wave of blocks (as many as fit
// on every SM, fewer where the groups run out), whose warps stride over the
// 32-sample groups.
template <typename T, bool kMasked, bool kSums>
cudaError_t launch_rows(const void* table, int table_rows, const int* rows, const int* slots, const float* w,
                        float* out, int n, int log2f, int block, int block_stride, int corner_stride, int corners,
                        cudaStream_t s) {
  auto kernel = gather_select_rows_kernel<T, kMasked, kSums>;
  const size_t smem = (size_t)kRowsWarps * kGroup *
                      (kSums ? kSumsCorners * sizeof(float4) + sizeof(float) + 32 : (size_t)corners * sizeof(int4));
  if (smem > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) != cudaSuccess)
    return err;
  int dev = 0, sms = 0, fit = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, kRowsWarps * 32, smem)) != cudaSuccess)
    return err;
  if (fit < 1) return cudaErrorInvalidConfiguration;
  const int groups = (n + kGroup - 1) / kGroup;
  int blocks = (groups + kRowsWarps - 1) / kRowsWarps;
  blocks = blocks < sms * fit ? blocks : sms * fit;
  kernel<<<blocks, kRowsWarps * 32, smem, s>>>((const T*)table, rows, slots, w, out, n, table_rows, log2f, block,
                                               block_stride, corner_stride, corners);
  return cudaGetLastError();
}

template <typename T, bool kMasked>
cudaError_t launch_rows_of(const void* table, int table_rows, const int* rows, const int* slots, const float* w,
                           float* out, int n, int log2f, int block, int block_stride, int corner_stride, int corners,
                           cudaStream_t s) {
  if (log2f == 2 && corners == kSumsCorners)
    return launch_rows<T, kMasked, true>(table, table_rows, rows, slots, w, out, n, log2f, block, block_stride,
                                         corner_stride, corners, s);
  return launch_rows<T, kMasked, false>(table, table_rows, rows, slots, w, out, n, log2f, block, block_stride,
                                        corner_stride, corners, s);
}

}  // namespace

extern "C" {

// Whole-row gather (stage1): table (table_rows, 128) of elem_bytes 4 (f32)
// or 2 (bf16), rows (out_rows,) int32, out (out_rows, 128), contiguous
// device arrays. Returns a cudaError_t (0 on success).
int nst_probe_row_gather(const void* table, const void* rows, void* out, long long out_rows,
                         long long table_rows, int elem_bytes, void* stream) {
  if (out_rows < 0 || table_rows < 1 || (elem_bytes != 2 && elem_bytes != 4)) return (int)cudaErrorInvalidValue;
  if (out_rows == 0) return (int)cudaSuccess;
  const int vpr = kLanes * elem_bytes / 16;
  const int64_t total = out_rows * vpr;
  row_gather_kernel<<<grid_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)table, (const int*)rows, (uint4*)out, total, vpr, table_rows);
  return (int)cudaGetLastError();
}

// Per-lane gather out[i, j] = table[row(rows[i, j]), j]: table (table_rows,
// 128) of elem_bytes 4 or 2, rows (m, 128) int32, out (m, 128) of the
// table's type, contiguous device arrays, table and rows 16-byte aligned.
// row() clamps (run_case) or, with modulo, takes Python's modulo by
// table_rows through (magic, shift) (f4). lanes: the table columns each
// block holds in shared memory (a power of two dividing 128, lanes *
// table_rows * elem_bytes <= 227 KB), or 0 for one thread per element.
// Returns a cudaError_t.
int nst_probe_lane_gather(const void* table, const void* rows, void* out, long long m, long long table_rows,
                          int elem_bytes, int modulo, int lanes, unsigned int magic, int shift, void* stream) {
  if (m < 0 || table_rows < 1 || table_rows > 0x7FFFFFFFLL || (elem_bytes != 2 && elem_bytes != 4) || lanes < 0 ||
      lanes > kLanes || (lanes & (lanes - 1)) != 0 || (long long)lanes * table_rows * elem_bytes > kMaxSharedBytes ||
      shift < 0 || shift > 31)
    return (int)cudaErrorInvalidValue;
  if (m == 0) return (int)cudaSuccess;
  const Divisor div = {(int)table_rows, magic, shift};
  const cudaStream_t s = (cudaStream_t)stream;
  const int* r = (const int*)rows;
  const int t = (int)table_rows;
  cudaError_t err;
  if (elem_bytes == 4)
    err = modulo ? launch_lane_gather<float, true>(table, r, out, m, t, lanes, div, s)
                 : launch_lane_gather<float, false>(table, r, out, m, t, lanes, div, s);
  else
    err = modulo ? launch_lane_gather<unsigned short, true>(table, r, out, m, t, lanes, div, s)
                 : launch_lane_gather<unsigned short, false>(table, r, out, m, t, lanes, div, s);
  return (int)err;
}

// Gather, lane select and corner sum. table (table_rows, 128) f32
// (elem_bytes 4) or bf16 (2); rows, slots (int32) and w (f32) hold `corners` entries per
// sample at the offsets of gather_select_kernel; out (n, 128) f32.
// masked 0: fused_gather's broadcast select, 1: stage2's masked lanes.
// features (F) must divide 128. Returns a cudaError_t.
int nst_probe_gather_select(const void* table, long long table_rows, int elem_bytes, const void* rows,
                            const void* slots, const void* w, void* out, long long n, int features, long long block,
                            long long block_stride, long long corner_stride, int corners, int masked,
                            void* stream) {
  if (n < 0 || table_rows < 1 || features < 1 || kLanes % features != 0 || block < 1 || corners < 1 ||
      (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned int g = grid_for(n * kLanes);
  const int* r = (const int*)rows;
  const int* sl = (const int*)slots;
  const float* wt = (const float*)w;
  float* o = (float*)out;
#define NST_SELECT(T, M)                                                                                    \
  gather_select_kernel<T, M><<<g, kThreads, 0, s>>>((const T*)table, r, sl, wt, o, n, table_rows, features, \
                                                     block, block_stride, corner_stride, corners)
  if (elem_bytes == 4) {
    if (masked) NST_SELECT(float, true); else NST_SELECT(float, false);
  } else {
    if (masked) NST_SELECT(unsigned short, true); else NST_SELECT(unsigned short, false);
  }
#undef NST_SELECT
  return (int)cudaGetLastError();
}

// The same gather, lane select and corner sum in rows (the default
// design): gather_select_rows_kernel, bit-equal to nst_probe_gather_select.
// features a power of two dividing 128; n, table_rows * 128 and every
// index offset below 2^31; with F = 4 and 8 corners the table 16-byte
// aligned. Returns a cudaError_t.
int nst_probe_gather_select_rows(const void* table, long long table_rows, int elem_bytes, const void* rows,
                                 const void* slots, const void* w, void* out, long long n, int features,
                                 long long block, long long block_stride, long long corner_stride, int corners,
                                 int masked, void* stream) {
  int log2f = 0;
  while ((1 << log2f) < features && log2f < 8) ++log2f;
  if (n < 0 || n > 0x7FFFFFFFLL || table_rows < 1 || table_rows > (0x7FFFFFFFLL / kLanes) || features < 1 ||
      (1 << log2f) != features || kLanes % features != 0 || block < 1 || block > 0x7FFFFFFFLL ||
      block_stride < 0 || corner_stride < 0 || corners < 1 || (elem_bytes != 2 && elem_bytes != 4))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const long long last = n - 1;
  const long long max_offset = (last / block) * block_stride + (block < n ? block - 1 : last) +
                               (long long)(corners - 1) * corner_stride;
  if (max_offset > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const int* r = (const int*)rows;
  const int* sl = (const int*)slots;
  const float* wt = (const float*)w;
  float* o = (float*)out;
#define NST_ROWS(T, M)                                                                                        \
  launch_rows_of<T, M>(table, (int)table_rows, r, sl, wt, o, (int)n, log2f, (int)block, (int)block_stride,    \
                       (int)corner_stride, corners, (cudaStream_t)stream)
  cudaError_t err;
  if (elem_bytes == 4) err = masked ? NST_ROWS(float, true) : NST_ROWS(float, false);
  else err = masked ? NST_ROWS(unsigned short, true) : NST_ROWS(unsigned short, false);
#undef NST_ROWS
  return (int)err;
}

const char* nst_probe_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
