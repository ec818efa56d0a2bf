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
//   * gather_select_kernel: exp/pallas_gather.py fused_gather (kernel) and
//     exp/pallas_gather2.py stage2 (g2_kernel), a row gather per corner, a
//     lane select and an 8-corner weighted sum: fused_gather broadcasts the
//     entry's F values to all 128 lanes (lane l reads slot*F + l%F),
//     stage2 keeps the lanes of the entry (l/F == slot) and zeroes the
//     rest.
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
//   * row_gather_kernel and gather_select_kernel follow the output:
//     consecutive threads write consecutive 16-byte vectors (row gather) or
//     consecutive lanes, so stores coalesce; the table reads hit L2.
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

// One thread per output element (sample k, lane). Corner c of sample k
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

const char* nst_probe_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
