// The hash-table gather probes, for Hopper (sm_90a). Plain C interface,
// loaded with ctypes by nerfstudio_torch/ops/gather_probes.py.
//
// Replaces the Pallas probes of the JAX package's exp/ directory (each
// gathered from a table held whole in the TPU's VMEM):
//   * row_gather_kernel: exp/pallas_gather2.py stage1 (g1_kernel), a
//     whole-row gather out[i, :] = table[rows[i], :];
//   * lane_gather_kernel: exp/pallas_gather3.py run_case (its nested
//     kernel), out[i, j] = table[rows[i, j], j], and exp/gather_bench.py f4
//     (gather_kernel), the same with rows[i, j] mod S (Python's modulo);
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
// the write of the output and the index reads set the bound. Threads
// follow the output: consecutive threads write consecutive 16-byte
// vectors (row gather) or consecutive lanes (the others), so stores
// coalesce; the table reads hit L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(unsigned short v) { return __uint_as_float(((unsigned int)v) << 16); }

__device__ __forceinline__ int64_t clamp_row(int64_t r, int64_t table_rows) {
  return r < 0 ? 0 : (r >= table_rows ? table_rows - 1 : r);
}

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

// One thread per output element.
template <typename T, bool kModulo>
__global__ void __launch_bounds__(kThreads)
    lane_gather_kernel(const T* __restrict__ table, const int* __restrict__ rows, T* __restrict__ out,
                       int64_t total, int64_t table_rows) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  int64_t r = __ldg(rows + t);
  if (kModulo) {
    r %= table_rows;
    if (r < 0) r += table_rows;
  } else {
    r = clamp_row(r, table_rows);
  }
  out[t] = table[r * kLanes + (t & (kLanes - 1))];
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

}  // namespace

extern "C" {

// Row gathers. table (table_rows, 128) of elem_bytes 4 (f32) or 2 (bf16)
// and out are contiguous device arrays. mode 0: rows (out_rows,), whole
// rows (stage1); mode 1: rows (out_rows, 128), one row per lane
// (run_case); mode 2: as 1 with rows mod table_rows (f4). Returns a
// cudaError_t (0 on success).
int nst_probe_row_gather(const void* table, const void* rows, void* out, long long out_rows,
                         long long table_rows, int elem_bytes, int mode, void* stream) {
  if (out_rows < 0 || table_rows < 1 || (elem_bytes != 2 && elem_bytes != 4) || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  if (out_rows == 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  const int* r = (const int*)rows;
  if (mode == 0) {
    const int vpr = kLanes * elem_bytes / 16;
    const int64_t total = out_rows * vpr;
    row_gather_kernel<<<grid_for(total), kThreads, 0, s>>>((const uint4*)table, r, (uint4*)out, total, vpr,
                                                            table_rows);
  } else {
    const int64_t total = out_rows * kLanes;
    const unsigned int g = grid_for(total);
    if (elem_bytes == 4) {
      const float* tab = (const float*)table;
      if (mode == 1) lane_gather_kernel<float, false><<<g, kThreads, 0, s>>>(tab, r, (float*)out, total, table_rows);
      else lane_gather_kernel<float, true><<<g, kThreads, 0, s>>>(tab, r, (float*)out, total, table_rows);
    } else {
      const unsigned short* tab = (const unsigned short*)table;
      unsigned short* o = (unsigned short*)out;
      if (mode == 1) lane_gather_kernel<unsigned short, false><<<g, kThreads, 0, s>>>(tab, r, o, total, table_rows);
      else lane_gather_kernel<unsigned short, true><<<g, kThreads, 0, s>>>(tab, r, o, total, table_rows);
    }
  }
  return (int)cudaGetLastError();
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
