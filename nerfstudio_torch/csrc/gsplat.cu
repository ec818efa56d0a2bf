// Gaussian-splatting kernels for Hopper (sm_90a): EWA projection forward and
// backward (K4), tile binning (K5) and the saturating front-to-back blend
// forward and backward (K6). Plain C interface, loaded with ctypes by
// nerfstudio_torch/ops/gsplat/_cuda.py.
//
// Replaces, in the JAX reference package:
//   * K4: nerfstudio_tpu/ops/gsplat/projection.py project_gaussians (with
//     quat_to_rotmat and compute_cov3d expanded into it, and the antialiased
//     compensation) and XLA's autodiff of it, into the viewmat too. The backward is the hand-derived VJP of exactly the forward's
//     chain, recomputed per gaussian from the inputs.
//   * K5: nerfstudio_tpu/ops/gsplat/rasterize.py _tile_keys_packed and
//     _window_tile_ids (key emission, with the big_frac second window and its
//     duplicate suppression), the sort and the per-tile searchsorted after
//     it: tile-bucketed by default (count, scan, scatter, per-tile sort,
//     all by hand); the first design's emission and range kernels, with a
//     library sort between them, stay for chip_smoke.py's comparison.
//   * K6: nerfstudio_tpu/ops/gsplat/rasterize.py _blend_saturating
//     (_blend_sat_batch_fwd, _alpha_from_gathered) and
//     _blend_saturating_bwd.
//
// What bounds them on this card:
//   * K4 is a fused elementwise pass: ~40 bytes in and ~30 bytes out per
//     gaussian and a few hundred flops, so its forward is bound by memory
//     traffic and launch latency (one thread per gaussian, structure of
//     arrays). Its backward recomputes the forward chain and runs the VJP,
//     several hundred instructions a gaussian, so it is bound by instruction
//     throughput and by the registers that set its occupancy as much as by
//     bytes: a persistent grid strides over the gaussians, the VJP goes
//     through T = J R with fused products and sums, and quats and d_quats
//     move as one 16-byte access a gaussian. Under camera optimisation the
//     viewmat comes from device memory and the same launch sums d(viewmat)
//     over the gaussians: per-thread sums in shared memory, one fixed-order
//     reduction per block, and the last block to finish sums the blocks'
//     partials in block order, so the gradient is deterministic (see the
//     comment above kBwdMinBlocks).
//   * K5 reads a few floats per gaussian and writes 12 bytes per live
//     (tile, gaussian) pair: bound by bytes at best, in practice by its
//     passes over the window slots and the per-tile sorts (see the comment
//     above tile_count_kernel).
//   * K6 is bound by the per-entry work inside a tile: each entry of a
//     tile's depth-sorted list costs every pixel of the tile an exp and a
//     few flops, and the backward adds the reduction of 11 gradient values
//     per (pixel, entry) over the tile. One block per 16x16 tile, one thread
//     per pixel; the entries are staged through shared memory 256 at a
//     time, so each is read from device memory once per tile. The
//     forward's default design culls per warp: each warp walks only the
//     staged entries whose conservative box meets its 8x4 pixels (bit-equal
//     to the first, per-pixel design, kept for chip_smoke.py). A pixel stops
//     once its transmittance falls below 1e-4 (after blending the entry that
//     took it there), and a block stops when all its pixels have; the
//     backward replays each pixel from its last blended entry back to the
//     front, recovering T by division, as gsplat does.
//   * K6's backward (blend_bwd_kernel) reduces in the block before it
//     touches device memory. Per staged batch each entry has 11 float
//     accumulators in shared memory; a warp sums its pixels' 11 values in
//     one butterfly (16 shuffles, not 11 tree sums of 5), adds them with one
//     shared-memory atomic per value, and after the batch the block flushes
//     every non-zero accumulator with one global atomic: one flush per entry
//     and tile instead of one per warp, and no two warps of a tile contend
//     for the same L2 line. Each warp replays from its own largest `last`,
//     not the block's. The staged entries keep the structure-of-arrays
//     layout of the forward (no float4 packing).
//
// The library is built with -fmad=false (cuda_build.NVCC_FLAGS), so every
// product and sum rounds as the plain PyTorch twins' do; the twins differ
// only in summation order. K4's backward alone fuses its VJP's products and
// sums on purpose (__fmaf_rn), after recomputing the forward chain unfused.

#include <cub/block/block_radix_sort.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kThreads = 256;
constexpr int kGradStride = 11;  // packed per-gaussian K6 gradient row
constexpr float kMinAlpha = 1.0f / 255.0f;
constexpr float kMaxAlpha = 0.999f;
constexpr float kTransmittanceEps = 1e-4f;
// Window arithmetic runs in int32: float tile coordinates are clamped to
// +-2^30 before the cast (only invalid gaussians, which emit no key, can
// reach beyond), so no cast is out of range.
constexpr float kCoordLimit = 1073741824.0f;

// w2c rotation (row-major) and translation, intrinsics, the clip limits of
// the EWA Jacobian (computed in float32 by the caller, as the reference
// does), the image size, the near plane and the 2D dilation.
struct Camera {
  float R[9];
  float t[3];
  float fx, fy, cx, cy;
  float lim_x, lim_y;
  float near_plane, eps2d;
  int width, height;
  int antialiased;  // write the compensation factor (else 1) and take its cotangent
};

// Gradient factor of max(x, y) with respect to x (ties split in halves, as
// the reference's autodiff does), and of min(x, y).
__device__ __forceinline__ float dmax(float x, float y) { return x > y ? 1.0f : (x == y ? 0.5f : 0.0f); }
__device__ __forceinline__ float dmin(float x, float y) { return x < y ? 1.0f : (x == y ? 0.5f : 0.0f); }

// ---------------------------------------------------------------------------
// K4: EWA projection

// Everything the backward needs from the forward chain of one gaussian.
struct Projected {
  float mx, my, mz;
  float px, py, z, inv_z, xs, ys;
  float Q[4], qnorm, qden, q[4];  // raw and normalised wxyz
  float g[9];                     // rotation of the gaussian, row-major
  float sc[3], s[3];              // linear scales and their squares
  float c[6];                     // cov3d: 00 01 02 11 12 22
  float a[9];                     // A = R_cam cov3d, row-major
  float v[6];                     // V = A R_cam^T: 00 01 02 11 12 22
  float txz, tyz, jx, jy, kx, ky;
  float cov00, cov01, cov11;      // cov2d after the dilation
  float pre00, pre11, det_orig;   // before the dilation
  float det, det_safe, inv_det;
};

// projection.py:64-150, operation for operation, on one gaussian's mean,
// raw quaternion (wxyz) and linear scales.
__device__ __forceinline__ void project_chain(const float m[3], const float Q[4], const float sc[3], const Camera& cam,
                                              Projected& p) {
  const float* R = cam.R;
  p.mx = m[0];
  p.my = m[1];
  p.mz = m[2];
  p.px = R[0] * p.mx + R[1] * p.my + R[2] * p.mz + cam.t[0];
  p.py = R[3] * p.mx + R[4] * p.my + R[5] * p.mz + cam.t[1];
  p.z = R[6] * p.mx + R[7] * p.my + R[8] * p.mz + cam.t[2];
  p.inv_z = 1.0f / fmaxf(p.z, 1e-6f);
  p.xs = p.px * p.inv_z;
  p.ys = p.py * p.inv_z;

  for (int k = 0; k < 4; ++k) p.Q[k] = Q[k];
  p.qnorm = sqrtf(p.Q[0] * p.Q[0] + p.Q[1] * p.Q[1] + p.Q[2] * p.Q[2] + p.Q[3] * p.Q[3]);
  p.qden = fmaxf(p.qnorm, 1e-8f);
  for (int k = 0; k < 4; ++k) p.q[k] = p.Q[k] / p.qden;
  const float qw = p.q[0], qx = p.q[1], qy = p.q[2], qz = p.q[3];
  float* g = p.g;
  g[0] = 1.0f - 2.0f * (qy * qy + qz * qz);
  g[1] = 2.0f * (qx * qy - qw * qz);
  g[2] = 2.0f * (qx * qz + qw * qy);
  g[3] = 2.0f * (qx * qy + qw * qz);
  g[4] = 1.0f - 2.0f * (qx * qx + qz * qz);
  g[5] = 2.0f * (qy * qz - qw * qx);
  g[6] = 2.0f * (qx * qz - qw * qy);
  g[7] = 2.0f * (qy * qz + qw * qx);
  g[8] = 1.0f - 2.0f * (qx * qx + qy * qy);
  for (int k = 0; k < 3; ++k) {
    p.sc[k] = sc[k];
    p.s[k] = p.sc[k] * p.sc[k];
  }
  // c_ij = sum_k g_ik g_jk s_k over the upper triangle
  const int ci[6] = {0, 0, 0, 1, 1, 2}, cj[6] = {0, 1, 2, 1, 2, 2};
  for (int e = 0; e < 6; ++e) {
    const float* gi = g + 3 * ci[e];
    const float* gj = g + 3 * cj[e];
    p.c[e] = gi[0] * gj[0] * p.s[0] + gi[1] * gj[1] * p.s[1] + gi[2] * gj[2] * p.s[2];
  }
  const float c00 = p.c[0], c01 = p.c[1], c02 = p.c[2], c11 = p.c[3], c12 = p.c[4], c22 = p.c[5];
  for (int r = 0; r < 3; ++r) {  // _rowA
    const float r0 = R[3 * r], r1 = R[3 * r + 1], r2 = R[3 * r + 2];
    p.a[3 * r + 0] = r0 * c00 + r1 * c01 + r2 * c02;
    p.a[3 * r + 1] = r0 * c01 + r1 * c11 + r2 * c12;
    p.a[3 * r + 2] = r0 * c02 + r1 * c12 + r2 * c22;
  }
  // v_ij = sum_k a_ik R_jk over the upper triangle
  for (int e = 0; e < 6; ++e) {
    const float* ai = p.a + 3 * ci[e];
    const float* rj = R + 3 * cj[e];
    p.v[e] = ai[0] * rj[0] + ai[1] * rj[1] + ai[2] * rj[2];
  }
  p.txz = fminf(fmaxf(p.xs, -cam.lim_x), cam.lim_x);
  p.tyz = fminf(fmaxf(p.ys, -cam.lim_y), cam.lim_y);
  p.jx = cam.fx * p.inv_z;
  p.jy = cam.fy * p.inv_z;
  p.kx = -cam.fx * p.txz * p.inv_z;
  p.ky = -cam.fy * p.tyz * p.inv_z;
  const float v00 = p.v[0], v01 = p.v[1], v02 = p.v[2], v11 = p.v[3], v12 = p.v[4], v22 = p.v[5];
  const float jx = p.jx, jy = p.jy, kx = p.kx, ky = p.ky;
  p.cov00 = jx * (jx * v00 + kx * v02) + kx * (jx * v02 + kx * v22);
  p.cov01 = jy * (jx * v01 + kx * v12) + ky * (jx * v02 + kx * v22);
  p.cov11 = jy * (jy * v11 + ky * v12) + ky * (jy * v12 + ky * v22);
  p.pre00 = p.cov00;
  p.pre11 = p.cov11;
  p.det_orig = p.cov00 * p.cov11 - p.cov01 * p.cov01;
  p.cov00 = p.cov00 + cam.eps2d;
  p.cov11 = p.cov11 + cam.eps2d;
  p.det = p.cov00 * p.cov11 - p.cov01 * p.cov01;
  p.det_safe = fmaxf(p.det, 1e-10f);
  p.inv_det = 1.0f / p.det_safe;
}

// project_chain on gaussian i of the (n, 3), (n, 4), (n, 3) inputs.
__device__ __forceinline__ void project_one(const float* __restrict__ means, const float* __restrict__ scales,
                                            const float* __restrict__ quats, int64_t i, const Camera& cam,
                                            Projected& p) {
  const float m[3] = {means[3 * i], means[3 * i + 1], means[3 * i + 2]};
  const float Q[4] = {quats[4 * i], quats[4 * i + 1], quats[4 * i + 2], quats[4 * i + 3]};
  const float sc[3] = {scales[3 * i], scales[3 * i + 1], scales[3 * i + 2]};
  project_chain(m, Q, sc, cam, p);
}

// The camera of a launch: the host's, with rows 0-2 of the viewmat read
// from device memory instead when kDevView (a viewmat the step computes on
// the card, e.g. under camera optimisation, is never copied to the host).
template <bool kDevView>
__device__ __forceinline__ Camera camera_of(const Camera& host, const float* __restrict__ view) {
  Camera cam = host;
  if (kDevView) {
    for (int r = 0; r < 3; ++r) {
      for (int k = 0; k < 3; ++k) cam.R[3 * r + k] = __ldg(view + 4 * r + k);
      cam.t[r] = __ldg(view + 4 * r + 3);
    }
  }
  return cam;
}

template <bool kDevView>
__global__ void __launch_bounds__(kThreads) project_fwd_kernel(
    const float* __restrict__ means, const float* __restrict__ scales, const float* __restrict__ quats,
    int64_t n, Camera host_cam, const float* __restrict__ view, float* __restrict__ means2d,
    float* __restrict__ depths, float* __restrict__ conics, float* __restrict__ radii, uint8_t* __restrict__ valid,
    float* __restrict__ comp) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Camera cam = camera_of<kDevView>(host_cam, view);
  Projected p;
  project_one(means, scales, quats, i, cam, p);
  const float m2x = p.xs * cam.fx + cam.cx;
  const float m2y = p.ys * cam.fy + cam.cy;
  const float b = 0.5f * (p.cov00 + p.cov11);
  const float v1 = b + sqrtf(fmaxf(b * b - p.det_safe, 0.01f));
  const float r = ceilf(3.0f * sqrtf(v1));
  const bool inside = (m2x + r > 0.0f) && (m2x - r < (float)cam.width) && (m2y + r > 0.0f) &&
                      (m2y - r < (float)cam.height);
  const bool ok = (p.z > cam.near_plane) && inside && (p.det > 0.0f);
  means2d[2 * i] = m2x;
  means2d[2 * i + 1] = m2y;
  depths[i] = p.z;
  conics[3 * i] = p.cov11 * p.inv_det;
  conics[3 * i + 1] = -p.cov01 * p.inv_det;
  conics[3 * i + 2] = p.cov00 * p.inv_det;
  radii[i] = ok ? r : 0.0f;
  valid[i] = ok ? 1 : 0;
  // antialiasing compensation sqrt(max(det_orig / det_safe, 0)) (reference :131)
  comp[i] = cam.antialiased ? sqrtf(fmaxf(p.det_orig / p.det_safe, 0.0f)) : 1.0f;
}

// K4's backward, one design for both routes (with and without the viewmat
// gradient). A persistent grid (as many blocks as fit on the card at once,
// at most one per 256 gaussians) strides over the gaussians, one thread a
// gaussian at a time. Per gaussian it recomputes project_chain
// exactly as the forward does (the float64 checks hold it to the float32
// twin's own error, which that chain's rounding sets), then runs the VJP
// with explicit fused products and sums (__fmaf_rn; the library is built
// with -fmad=false) through T = J R, the 2x3 product of the EWA Jacobian and
// the camera rotation, rather than A = R cov3d and V = A R^T: cov2d = T
// cov3d T^T, so d(cov3d) = T^T W T and dT = 2 W T cov3d for the symmetric
// cotangent W of cov2d, and d(cov3d) reaches the rotation as 2 d(cov3d) G S.
// The quaternion's normalisation takes its gradient as a projection, (dq -
// (dq . q) q) / max(|Q|, 1e-8), with one reciprocal. With kGradView every
// thread sums its gaussians' d(viewmat rows 0-2) in a fixed order, in its
// column of shared memory (12 registers fewer), each block reduces once in
// a fixed order into its 12-float partial, and the last block to finish (a
// ticket taken after a fence) sums the partials in block order, writes the
// (4, 4) gradient and resets the ticket: one launch, and two runs give the
// same bits on one card. Both routes keep three blocks resident per SM (at
// most 85 registers; 72 and 80 on the H100, the viewmat route with 12 bytes
// of spill, which measured faster than its unbounded 96 registers at two
// blocks, and four blocks at 64 measured slower). Where most gaussians have
// no cotangent (a trained step: 98% of 1M slots) the loop is a stream of
// their cotangents, so each iteration prefetches the next one's into L2.
// Staging the stride-3 rows through shared memory measured slower than
// these direct loads, which the L1 serves from the same lines; a grid of
// one block per 256 gaussians measured slower than the persistent one.

// Blocks of K4's backward resident per SM: the launch bounds' minimum
constexpr int kBwdMinBlocks = 3;

__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }

// One gaussian's cotangents (dk: the compensation's, 0 unless antialiased)
// and gradients.
struct K4Cot {
  float dm2x, dm2y, dz, dc0, dc1, dc2, dk;
};
struct K4Grad {
  float dm[3], ds[3];
  float4 dq;
};

// The viewmat gradient's per-thread running sums, 12 floats row-major
// [R | t], in the thread's column of shared memory (col[k * kThreads]).
struct ViewAcc {
  float* col;
  __device__ __forceinline__ void add(int k, float v) { col[k * kThreads] += v; }
};

// The VJP of project_chain for gaussian i into its mean, scales and raw
// quaternion; with kGradView also adds its d(viewmat rows 0-2) into acc. A
// gaussian without a cotangent (one no tile blended) reads nothing more and
// gets zero gradients.
template <bool kGradView>
__device__ __forceinline__ void project_bwd_one(const float* __restrict__ means, const float* __restrict__ scales,
                                                const float4* __restrict__ quats, int64_t i, const Camera& cam,
                                                const K4Cot& ct, K4Grad& out, ViewAcc& acc) {
  if (ct.dm2x == 0.0f && ct.dm2y == 0.0f && ct.dz == 0.0f && ct.dc0 == 0.0f && ct.dc1 == 0.0f && ct.dc2 == 0.0f &&
      ct.dk == 0.0f) {
    for (int k = 0; k < 3; ++k) out.dm[k] = out.ds[k] = 0.0f;
    out.dq = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  const float4 qv = __ldg(quats + i);
  const float m[3] = {__ldg(means + 3 * i), __ldg(means + 3 * i + 1), __ldg(means + 3 * i + 2)};
  const float Q[4] = {qv.x, qv.y, qv.z, qv.w};
  const float sc[3] = {__ldg(scales + 3 * i), __ldg(scales + 3 * i + 1), __ldg(scales + 3 * i + 2)};
  Projected p;
  project_chain(m, Q, sc, cam, p);
  const float* R = cam.R;

  // T = J R, J = [[jx, 0, kx], [0, jy, ky]], and TC = T cov3d
  const float C[9] = {p.c[0], p.c[1], p.c[2], p.c[1], p.c[3], p.c[4], p.c[2], p.c[4], p.c[5]};
  float T0[3], T1[3], TC0[3], TC1[3];
  for (int k = 0; k < 3; ++k) {
    T0[k] = fma_rn(p.jx, R[k], p.kx * R[6 + k]);
    T1[k] = fma_rn(p.jy, R[3 + k], p.ky * R[6 + k]);
  }
  for (int k = 0; k < 3; ++k) {
    TC0[k] = fma_rn(T0[0], C[k], fma_rn(T0[1], C[3 + k], T0[2] * C[6 + k]));
    TC1[k] = fma_rn(T1[0], C[k], fma_rn(T1[1], C[3 + k], T1[2] * C[6 + k]));
  }

  // conics = (cov11, -cov01, cov00) * inv_det of the dilated cov2d
  float d00 = ct.dc2 * p.inv_det, d01 = -ct.dc1 * p.inv_det, d11 = ct.dc0 * p.inv_det;
  const float d_inv_det = fma_rn(ct.dc0, p.cov11, fma_rn(-ct.dc1, p.cov01, ct.dc2 * p.cov00));
  float d_det_safe = -d_inv_det * p.inv_det * p.inv_det;
  if (ct.dk != 0.0f) {
    // comp = sqrt(max(r, 0)), r = det_orig / det_safe; det_orig of the
    // undilated cov2d, whose entries have the dilated ones' gradient
    const float r = p.det_orig * p.inv_det;
    if (r > 0.0f) {
      const float d_det_orig = 0.5f * ct.dk * rsqrtf(r) * p.inv_det;
      d_det_safe = fma_rn(-d_det_orig, r, d_det_safe);
      d00 = fma_rn(d_det_orig, p.pre11, d00);
      d11 = fma_rn(d_det_orig, p.pre00, d11);
      d01 = fma_rn(-2.0f * p.cov01, d_det_orig, d01);
    }
  }
  const float d_det = d_det_safe * dmax(p.det, 1e-10f);
  d00 = fma_rn(d_det, p.cov11, d00);
  d11 = fma_rn(d_det, p.cov00, d11);
  d01 = fma_rn(-2.0f * p.cov01, d_det, d01);

  // cov2d = T cov3d T^T with W = [[d00, h], [h, d11]] its symmetric
  // cotangent: dT = 2 W TC, d(cov3d) = E = T^T W T
  const float h = 0.5f * d01;
  float dT0[3], dT1[3];
  for (int k = 0; k < 3; ++k) {
    dT0[k] = 2.0f * fma_rn(d00, TC0[k], h * TC1[k]);
    dT1[k] = 2.0f * fma_rn(h, TC0[k], d11 * TC1[k]);
  }

  // T = J R into J: jx = fx inv_z, kx = -fx txz inv_z (and y); txz =
  // min(max(xs, -lim), lim); means2d = (xs fx + cx, ys fy + cy), xs = px inv_z
  const float d_jx = fma_rn(dT0[0], R[0], fma_rn(dT0[1], R[1], dT0[2] * R[2]));
  const float d_kx = fma_rn(dT0[0], R[6], fma_rn(dT0[1], R[7], dT0[2] * R[8]));
  const float d_jy = fma_rn(dT1[0], R[3], fma_rn(dT1[1], R[4], dT1[2] * R[5]));
  const float d_ky = fma_rn(dT1[0], R[6], fma_rn(dT1[1], R[7], dT1[2] * R[8]));
  float d_inv_z = fma_rn(cam.fx, fma_rn(-d_kx, p.txz, d_jx), cam.fy * fma_rn(-d_ky, p.tyz, d_jy));
  const float gx = dmax(p.xs, -cam.lim_x) * dmin(fmaxf(p.xs, -cam.lim_x), cam.lim_x);
  const float gy = dmax(p.ys, -cam.lim_y) * dmin(fmaxf(p.ys, -cam.lim_y), cam.lim_y);
  const float d_xs = fma_rn(-d_kx * p.jx, gx, ct.dm2x * cam.fx);
  const float d_ys = fma_rn(-d_ky * p.jy, gy, ct.dm2y * cam.fy);
  const float d_px = d_xs * p.inv_z, d_py = d_ys * p.inv_z;
  d_inv_z = fma_rn(d_xs, p.px, fma_rn(d_ys, p.py, d_inv_z));
  // inv_z = 1 / max(z, 1e-6); depths = z; p = R m + t
  const float d_z = fma_rn(-d_inv_z * p.inv_z, p.inv_z * dmax(p.z, 1e-6f), ct.dz);
  for (int k = 0; k < 3; ++k) out.dm[k] = fma_rn(R[k], d_px, fma_rn(R[3 + k], d_py, R[6 + k] * d_z));
  if (kGradView) {  // through p = R m + t and T = J R, one term per entry
    for (int k = 0; k < 3; ++k) {
      acc.add(k, fma_rn(d_px, m[k], p.jx * dT0[k]));
      acc.add(4 + k, fma_rn(d_py, m[k], p.jy * dT1[k]));
      acc.add(8 + k, fma_rn(d_z, m[k], fma_rn(p.kx, dT0[k], p.ky * dT1[k])));
    }
    acc.add(3, d_px);
    acc.add(7, d_py);
    acc.add(11, d_z);
  }

  float WT0[3], WT1[3];
  for (int k = 0; k < 3; ++k) {
    WT0[k] = fma_rn(d00, T0[k], h * T1[k]);
    WT1[k] = fma_rn(h, T0[k], d11 * T1[k]);
  }
  float E[9];
  for (int a = 0; a < 3; ++a)
    for (int b = a; b < 3; ++b) E[3 * a + b] = E[3 * b + a] = fma_rn(T0[a], WT0[b], T1[a] * WT1[b]);

  // cov3d = G S G^T: d(scale^2)_k = (G^T E G)_kk, dG = 2 E G S
  const float* g = p.g;
  float EG[9];
  for (int a = 0; a < 3; ++a)
    for (int k = 0; k < 3; ++k)
      EG[3 * a + k] = fma_rn(E[3 * a], g[k], fma_rn(E[3 * a + 1], g[3 + k], E[3 * a + 2] * g[6 + k]));
  for (int k = 0; k < 3; ++k) {
    const float ds = fma_rn(g[k], EG[k], fma_rn(g[3 + k], EG[3 + k], g[6 + k] * EG[6 + k]));
    out.ds[k] = 2.0f * p.sc[k] * ds;
  }
  float hg[9];  // dG / 2
  for (int a = 0; a < 3; ++a)
    for (int k = 0; k < 3; ++k) hg[3 * a + k] = EG[3 * a + k] * p.s[k];

  // G from the normalised quaternion q (wxyz), then q = Q / max(|Q|, 1e-8):
  // dQ = (dq - dmax (dq . q) q) / max(|Q|, 1e-8)
  const float qw = p.q[0], qx = p.q[1], qy = p.q[2], qz = p.q[3];
  const float a1 = hg[1] + hg[3], b1 = hg[3] - hg[1], a2 = hg[2] + hg[6], b2 = hg[2] - hg[6];
  const float a5 = hg[5] + hg[7], b5 = hg[7] - hg[5];
  const float dq[4] = {
      4.0f * fma_rn(qz, b1, fma_rn(qy, b2, qx * b5)),
      4.0f * fma_rn(qy, a1, fma_rn(qz, a2, fma_rn(qw, b5, -2.0f * qx * (hg[4] + hg[8])))),
      4.0f * fma_rn(qx, a1, fma_rn(qw, b2, fma_rn(qz, a5, -2.0f * qy * (hg[0] + hg[8])))),
      4.0f * fma_rn(qw, b1, fma_rn(qx, a2, fma_rn(qy, a5, -2.0f * qz * (hg[0] + hg[4])))),
  };
  const float rq = 1.0f / p.qden;
  const float proj = -fma_rn(dq[0], qw, fma_rn(dq[1], qx, fma_rn(dq[2], qy, dq[3] * qz))) * dmax(p.qnorm, 1e-8f);
  out.dq = make_float4(fma_rn(proj, qw, dq[0]) * rq, fma_rn(proj, qx, dq[1]) * rq, fma_rn(proj, qy, dq[2]) * rq,
                       fma_rn(proj, qz, dq[3]) * rq);
}

// Sums v (12 values per thread) over the block in a fixed order (a shuffle
// tree in each warp, then a tree over the warps) into sums[0..11] in shared
// memory: the same inputs give the same bits on every run.
__device__ __forceinline__ void block_sum_12(float* v, float* sums) {
  __shared__ float warp_sums[12][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < 12; ++k)
    for (int off = 16; off > 0; off >>= 1) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  if (lane == 0)
    for (int k = 0; k < 12; ++k) warp_sums[k][warp] = v[k];
  __syncthreads();
  if (threadIdx.x < 12) {
    float* w = warp_sums[threadIdx.x];
    for (int half = kThreads / 64; half > 0; half >>= 1)
      for (int j = 0; j < half; ++j) w[j] += w[j + half];
    sums[threadIdx.x] = w[0];
  }
  __syncthreads();
}

// The end of a kGradView launch: the block's partial (thread 0 writes it,
// fences and takes the ticket; in the last block it fences again before the
// block reads the others' partials), then, in the last block to take the
// ticket, the sum of every block's partial in block order into d_view
// (4, 4), its last row zero. The ticket is zero at every launch and left
// zero.
__device__ __forceinline__ void view_grad_finish(float* v, float* __restrict__ partials,
                                                 unsigned int* __restrict__ ticket, float* __restrict__ d_view) {
  __shared__ float sums[12];
  __shared__ bool last;
  block_sum_12(v, sums);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 12; ++k) partials[12 * (int64_t)blockIdx.x + k] = sums[k];
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;
  for (int k = 0; k < 12; ++k) v[k] = 0.0f;
  for (unsigned int b = threadIdx.x; b < gridDim.x; b += kThreads)
    for (int k = 0; k < 12; ++k) v[k] += __ldcg(partials + 12 * (int64_t)b + k);
  block_sum_12(v, sums);
  if (threadIdx.x < 16) d_view[threadIdx.x] = threadIdx.x < 12 ? sums[threadIdx.x] : 0.0f;
  if (threadIdx.x == 0) *ticket = 0u;
}

template <bool kDevView, bool kGradView>
__global__ void __launch_bounds__(kThreads, kBwdMinBlocks) project_bwd_kernel(
    const float* __restrict__ means, const float* __restrict__ scales, const float4* __restrict__ quats, int64_t n,
    Camera host_cam, const float* __restrict__ view, const float* __restrict__ d_means2d,
    const float* __restrict__ d_depths, const float* __restrict__ d_conics, const float* __restrict__ d_comp,
    float* __restrict__ d_means, float* __restrict__ d_scales, float4* __restrict__ d_quats,
    float* __restrict__ partials, unsigned int* __restrict__ ticket, float* __restrict__ d_view) {
  const Camera cam = camera_of<kDevView>(host_cam, view);
  __shared__ float acc_cols[kGradView ? 12 * kThreads : 1];
  ViewAcc acc = {acc_cols + threadIdx.x};
  if (kGradView)
    for (int k = 0; k < 12; ++k) acc.col[k * kThreads] = 0.0f;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride) {
    if (i + stride < n) {  // the next gaussian's cotangents into L2 (see above)
      const int64_t j = i + stride;
      asm volatile("prefetch.global.L2 [%0];" ::"l"(d_means2d + 2 * j));
      asm volatile("prefetch.global.L2 [%0];" ::"l"(d_depths + j));
      asm volatile("prefetch.global.L2 [%0];" ::"l"(d_conics + 3 * j));
      if (cam.antialiased) asm volatile("prefetch.global.L2 [%0];" ::"l"(d_comp + j));
    }
    const K4Cot ct = {d_means2d[2 * i], d_means2d[2 * i + 1], d_depths[i], d_conics[3 * i], d_conics[3 * i + 1],
                      d_conics[3 * i + 2], cam.antialiased ? d_comp[i] : 0.0f};
    K4Grad gr;
    project_bwd_one<kGradView>(means, scales, quats, i, cam, ct, gr, acc);
    for (int k = 0; k < 3; ++k) {
      d_means[3 * i + k] = gr.dm[k];
      d_scales[3 * i + k] = gr.ds[k];
    }
    d_quats[i] = gr.dq;
  }
  if (kGradView) {
    float v[12];
    for (int k = 0; k < 12; ++k) v[k] = acc.col[k * kThreads];
    view_grad_finish(v, partials, ticket, d_view);
  }
}

// ---------------------------------------------------------------------------
// K5: tile binning

struct TileGrid {
  int tiles_x, tiles_y, num_tiles;
  int depth_bits, id_bits;
};

__device__ __forceinline__ int tile_coord(float x) {
  return (int)fminf(fmaxf(floorf(x), -kCoordLimit), kCoordLimit);
}

// The emission window of _window_tile_ids: its bbox in tiles and its start.
struct Window {
  int x0t, y0t, x1t, y1t, sx, sy;
};

__device__ __forceinline__ Window make_window(float mx, float my, float r, const TileGrid& tg, int d) {
  Window w;
  w.x0t = tile_coord((mx - r) / (float)kTile);
  w.y0t = tile_coord((my - r) / (float)kTile);
  w.x1t = tile_coord((mx + r) / (float)kTile);
  w.y1t = tile_coord((my + r) / (float)kTile);
  const int cxt = tile_coord(mx / (float)kTile);
  const int cyt = tile_coord(my / (float)kTile);
  const int half_w = (d - 1) / 2;
  const int lo_x = max(w.x0t, 0), hi_x = min(w.x1t, tg.tiles_x - 1);
  const int lo_y = max(w.y0t, 0), hi_y = min(w.y1t, tg.tiles_y - 1);
  w.sx = min(max(cxt - half_w, lo_x), max(lo_x, hi_x - d + 1));
  w.sy = min(max(cyt - half_w, lo_y), max(lo_y, hi_y - d + 1));
  return w;
}

// Tile of window slot (dx, dy), or num_tiles when the slot falls outside the
// screen or the bbox.
__device__ __forceinline__ int window_tile(const Window& w, int dx, int dy, const TileGrid& tg) {
  const int tx = w.sx + dx, ty = w.sy + dy;
  const bool ok = tx >= 0 && tx < tg.tiles_x && tx >= w.x0t && tx <= w.x1t && ty >= 0 && ty < tg.tiles_y &&
                  ty >= w.y0t && ty <= w.y1t;
  return ok ? ty * tg.tiles_x + tx : tg.num_tiles;
}

// The emission's (tile, gaussian) pairs, numbered as the reference
// concatenates its slots: pair i < d*d*n is base-window slot i / n of
// gaussian i % n (slot-major), pair d*d*n + j is big-window slot j / n_big
// of gaussian idx_big[j % n_big] (the n_big largest radii).
struct Emission {
  const float* means2d;
  const float* radii;
  const float* depths;
  const uint8_t* valid;
  int64_t n;
  const int64_t* idx_big;
  int64_t n_big;
  TileGrid tg;
  int d, d_big;
};

__host__ __device__ __forceinline__ int64_t pair_count(const Emission& e) {
  return (int64_t)e.d * e.d * e.n + (int64_t)e.d_big * e.d_big * e.n_big;
}

// Pair i's tile, or num_tiles when the slot is dead (an invalid gaussian, a
// slot off screen or outside the bbox, a big-window tile the base window
// already emitted), and its gaussian.
__device__ __forceinline__ int pair_tile(const Emission& e, int64_t i, int64_t* gid) {
  const TileGrid& tg = e.tg;
  const int64_t n_base = (int64_t)e.d * e.d * e.n;
  int tile = tg.num_tiles;
  if (i < n_base) {
    const int slot = (int)(i / e.n);
    const int64_t g = i % e.n;
    *gid = g;
    if (e.valid[g]) {
      const Window w = make_window(e.means2d[2 * g], e.means2d[2 * g + 1], e.radii[g], tg, e.d);
      tile = window_tile(w, slot % e.d, slot / e.d, tg);
    }
  } else {
    const int64_t j = i - n_base;
    const int slot = (int)(j / e.n_big);
    const int64_t g = e.idx_big[j % e.n_big];
    *gid = g;
    // only splats wider than the base window get the big pass
    if (e.valid[g] && e.radii[g] > (float)(e.d * kTile) / 2.0f) {
      const float mx = e.means2d[2 * g], my = e.means2d[2 * g + 1], r = e.radii[g];
      const Window wb = make_window(mx, my, r, tg, e.d_big);
      tile = window_tile(wb, slot % e.d_big, slot / e.d_big, tg);
      if (tile < tg.num_tiles) {
        // drop the tiles the base window already emitted
        const Window w = make_window(mx, my, r, tg, e.d);
        const int tx = tile % tg.tiles_x, ty = tile / tg.tiles_x;
        if (tx >= w.sx && tx < w.sx + e.d && ty >= w.sy && ty < w.sy + e.d) tile = tg.num_tiles;
      }
    }
  }
  return tile;
}

// ((tile << depth_bits | depth bits) << id_bits | id): the depth bits are
// the top bits of the positive float32 pattern, which orders as the floats.
__device__ __forceinline__ uint64_t packed_key(const Emission& e, int tile, int64_t gid) {
  const uint32_t dq = __float_as_uint(fmaxf(e.depths[gid], 1e-20f)) >> (32 - e.tg.depth_bits);
  const uint64_t key = ((uint64_t)(uint32_t)tile << e.tg.depth_bits) | dq;
  return (key << e.tg.id_bits) | (uint64_t)gid;
}

// The first design ("sorted"): one thread per pair writes its packed key,
// sentinel tile num_tiles for a dead slot; torch.sort sorts all of them and
// tile_ranges_kernel finds the tiles' ranges. Kept so that chip_smoke.py
// can time it beside the tile-bucketed design.
__global__ void __launch_bounds__(kThreads) tile_keys_kernel(Emission e, int64_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= pair_count(e)) return;
  int64_t gid;
  const int tile = pair_tile(e, i, &gid);
  out[i] = (int64_t)packed_key(e, tile, gid);
}

__device__ __forceinline__ int64_t lower_bound(const int64_t* __restrict__ a, int64_t m, int64_t v) {
  int64_t lo = 0, hi = m;
  while (lo < hi) {
    const int64_t mid = lo + (hi - lo) / 2;
    if (a[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Thread i < m unpacks the id of sorted entry i; thread t < num_tiles finds
// tile t's [start, start + count) by searching its first possible key.
__global__ void __launch_bounds__(kThreads) tile_ranges_kernel(const int64_t* __restrict__ packed, int64_t m,
                                                               TileGrid tg, int32_t* __restrict__ ids,
                                                               int32_t* __restrict__ starts,
                                                               int32_t* __restrict__ counts) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m) ids[i] = (int32_t)(packed[i] & ((1LL << tg.id_bits) - 1));
  if (i < tg.num_tiles) {
    const int shift = tg.depth_bits + tg.id_bits;
    const int64_t lo = lower_bound(packed, m, i << shift);
    const int64_t hi = lower_bound(packed, m, (i + 1) << shift);
    starts[i] = (int32_t)lo;
    counts[i] = (int32_t)(hi - lo);
  }
}

// The live pairs of emission unit u, as fn(tile, gaussian): unit u < n is
// gaussian u's base window, unit n + j the big window of idx_big[j] minus
// the base window's slots. These are pair_tile's live pairs: the slots of
// a window that lie on screen and inside the bbox form one rectangle of
// tiles, so a unit computes its windows once and walks that rectangle.
template <class Fn>
__device__ __forceinline__ void unit_pairs(const Emission& e, int64_t u, Fn&& fn) {
  const TileGrid& tg = e.tg;
  const bool base = u < e.n;
  const int64_t g = base ? u : e.idx_big[u - e.n];
  if (!e.valid[g]) return;
  const float mx = e.means2d[2 * g], my = e.means2d[2 * g + 1], r = e.radii[g];
  // only splats wider than the base window get the big pass
  if (!base && !(r > (float)(e.d * kTile) / 2.0f)) return;
  const int side = base ? e.d : e.d_big;
  const Window w = make_window(mx, my, r, tg, side);
  const int x0 = max(max(w.sx, w.x0t), 0), x1 = min(min(w.sx + side - 1, w.x1t), tg.tiles_x - 1);
  const int y0 = max(max(w.sy, w.y0t), 0), y1 = min(min(w.sy + side - 1, w.y1t), tg.tiles_y - 1);
  int bx0 = 1, bx1 = 0, by0 = 1, by1 = 0;  // the base window's slots, skipped by the big one
  if (!base) {
    const Window wb = make_window(mx, my, r, tg, e.d);
    bx0 = wb.sx, bx1 = wb.sx + e.d - 1, by0 = wb.sy, by1 = wb.sy + e.d - 1;
  }
  for (int ty = y0; ty <= y1; ++ty) {
    for (int tx = x0; tx <= x1; ++tx) {
      if (!(tx >= bx0 && tx <= bx1 && ty >= by0 && ty <= by1)) fn(ty * tg.tiles_x + tx, g);
    }
  }
}

// The second design ("bucketed", the default): a counting sort by tile,
// then a sort of each tile's keys in shared memory. What bounds the first
// design is its sort: every slot of the window emits a 64-bit key, dead
// slots a sentinel (1.1M of 2.0M at splatfacto's 100k slots and 512^2),
// and torch.sort moves all of them several times and returns indices. The
// tile is the primary key and there are few tiles (1,024 at 512^2), so:
//   1. tile_count_kernel: one thread per gaussian (and per big-window
//      gaussian) computes its window once and walks its live tiles
//      (unit_pairs); each pair adds one to its tile's count in a per-block
//      histogram in shared memory (num_tiles ints), flushed with one global
//      atomic per nonzero bin;
//   2. tile_scan_kernel: one block scans the counts into the tiles' starts
//      (and a copy, the scatter's cursors);
//   3. tile_scatter_kernel: each block counts its units' pairs, reserves each
//      tile's run of slots with one atomic on the tile's cursor, and writes
//      its live pairs' packed keys there in any order;
//   4. tile_sort_kernel: one block per tile sorts the tile's keys (CUB's
//      block radix sort on the bits below the tile prefix, 1,024 or 2,048
//      keys at once) and writes the packed keys and the ids. A longer tile
//      is sorted in runs of 2,048 keys, which the block then merges pairwise
//      in global memory (merge path: each thread binary-searches the split
//      of its range of outputs and merges it sequentially), ping-ponging
//      between the scatter's buffer and the output.
// Every (tile, gaussian) pair is emitted once, so the keys within a tile are
// unique, and the result is exactly the first design's on the live entries,
// whatever order the atomics ran in. Nothing is read back to the host.
// Entries of packed and ids at and after the live count are not written.
constexpr int kBinThreads = 1024;
constexpr int kSortThreads = 256;
constexpr int kSortItems = 8;  // keys per thread in a tile's sort
constexpr int kSortKeys = kSortThreads * kSortItems;  // a tile sorted at once: 2,048 keys
constexpr int kMaxSharedBytes = 232448;  // one block's opt-in maximum on the H100

__global__ void __launch_bounds__(kBinThreads) tile_count_kernel(Emission e, int32_t* __restrict__ counts) {
  extern __shared__ int32_t hist[];
  const int nt = e.tg.num_tiles;
  for (int j = threadIdx.x; j < nt; j += kBinThreads) hist[j] = 0;
  __syncthreads();
  const int64_t units = e.n + e.n_big;
  for (int64_t u = (int64_t)blockIdx.x * kBinThreads + threadIdx.x; u < units; u += (int64_t)gridDim.x * kBinThreads)
    unit_pairs(e, u, [&](int tile, int64_t) { atomicAdd(&hist[tile], 1); });
  __syncthreads();
  for (int j = threadIdx.x; j < nt; j += kBinThreads)
    if (hist[j] != 0) atomicAdd(&counts[j], hist[j]);
}

// Exclusive scan of the counts into starts and cursor (the same values),
// kBinThreads tiles at a time: warp scans, a scan of the warps' sums, and a
// carry across rounds.
__global__ void __launch_bounds__(kBinThreads) tile_scan_kernel(const int32_t* __restrict__ counts, int nt,
                                                                int32_t* __restrict__ starts,
                                                                int32_t* __restrict__ cursor) {
  __shared__ int32_t sums[kBinThreads / 32];
  const unsigned lane = threadIdx.x & 31u;
  const int warp = threadIdx.x >> 5;
  int32_t carry = 0;
  for (int b = 0; b < nt; b += kBinThreads) {
    const int j = b + threadIdx.x;
    const int32_t v = j < nt ? counts[j] : 0;
    int32_t x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= (unsigned)o) x += y;
    }
    if (lane == 31u) sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int32_t y = sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t z = __shfl_up_sync(0xffffffffu, y, o);
        if (lane >= (unsigned)o) y += z;
      }
      sums[lane] = y;
    }
    __syncthreads();
    const int32_t excl = carry + (warp > 0 ? sums[warp - 1] : 0) + x - v;
    if (j < nt) {
      starts[j] = excl;
      cursor[j] = excl;
    }
    carry += sums[kBinThreads / 32 - 1];
    __syncthreads();  // sums is rewritten in the next round
  }
}

// A block first counts its own units' pairs per tile, then reserves that
// many slots of each tile with one atomic on the tile's cursor.
__global__ void __launch_bounds__(kBinThreads) tile_scatter_kernel(Emission e, int32_t* __restrict__ cursor,
                                                                   int64_t* __restrict__ keys) {
  extern __shared__ int32_t next[];  // per tile: this block's count, then its next slot
  const int nt = e.tg.num_tiles;
  for (int j = threadIdx.x; j < nt; j += kBinThreads) next[j] = 0;
  __syncthreads();
  const int64_t units = e.n + e.n_big;
  const int64_t first = (int64_t)blockIdx.x * kBinThreads + threadIdx.x, stride = (int64_t)gridDim.x * kBinThreads;
  for (int64_t u = first; u < units; u += stride)
    unit_pairs(e, u, [&](int tile, int64_t) { atomicAdd(&next[tile], 1); });
  __syncthreads();
  for (int j = threadIdx.x; j < nt; j += kBinThreads) {
    const int32_t c = next[j];
    if (c != 0) next[j] = atomicAdd(&cursor[j], c);
  }
  __syncthreads();
  for (int64_t u = first; u < units; u += stride)
    unit_pairs(e, u, [&](int tile, int64_t g) { keys[atomicAdd(&next[tile], 1)] = (int64_t)packed_key(e, tile, g); });
}

// A tile's keys sorted by one block with CUB's block radix sort (a tool
// inside this kernel, not a library kernel) on the bits below the tile
// prefix: kSortThreads * kItems keys at once, striped in and out so that
// loads and stores are coalesced; padding keys (~0) sort last, since a real
// key's top depth bit, the depth's float sign, is 0.
template <int kItems>
using TileSort = cub::BlockRadixSort<unsigned long long, kSortThreads, kItems>;

union TileSortStorage {
  typename TileSort<kSortItems / 2>::TempStorage half;
  typename TileSort<kSortItems>::TempStorage full;
};

// src[0, m) sorted into dst[0, m) (src may be dst), and each key's id into
// ids[0, m) unless ids is null; m <= kSortThreads * kItems. The caller
// syncs the block before it uses `storage` again.
template <int kItems>
__device__ void sort_run(const unsigned long long* src, int m, int end_bit, TileSortStorage& storage,
                         unsigned long long* dst, int32_t* ids, unsigned long long id_mask) {
  unsigned long long k[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int idx = i * kSortThreads + (int)threadIdx.x;
    k[i] = idx < m ? src[idx] : ~0ull;
  }
  TileSort<kItems>(reinterpret_cast<typename TileSort<kItems>::TempStorage&>(storage))
      .SortBlockedToStriped(k, 0, end_bit);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int idx = i * kSortThreads + (int)threadIdx.x;
    if (idx < m) {
      dst[idx] = k[i];
      if (ids != nullptr) ids[idx] = (int32_t)(k[i] & id_mask);
    }
  }
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }

// Elements [k0, k1) of the merge of sorted a[0, la) and b[0, lb), a first
// on ties, into out[k0, k1): a binary search finds the split of k0 (how
// many of the first k0 come from a), then a sequential merge.
__device__ void merge_range(const unsigned long long* a, int64_t la, const unsigned long long* b, int64_t lb,
                            int64_t k0, int64_t k1, unsigned long long* out) {
  int64_t lo = k0 > lb ? k0 - lb : 0, hi = k0 < la ? k0 : la;
  while (lo < hi) {
    const int64_t mid = (lo + hi) / 2;
    if (a[mid] <= b[k0 - 1 - mid])
      lo = mid + 1;
    else
      hi = mid;
  }
  int64_t i = lo, j = k0 - lo;
  for (int64_t k = k0; k < k1; ++k) out[k] = (j >= lb || (i < la && a[i] <= b[j])) ? a[i++] : b[j++];
}

// One block per tile: keys[starts[t], + counts[t]) (the scatter's, unsorted)
// sorted into packed and ids at the same place, on the low end_bit bits
// (depth and id; the tile prefix is the same for all).
__global__ void __launch_bounds__(kSortThreads) tile_sort_kernel(const int32_t* __restrict__ starts,
                                                                 const int32_t* __restrict__ counts, int64_t* keys,
                                                                 int64_t* packed, int32_t* __restrict__ ids,
                                                                 int end_bit, int id_bits) {
  __shared__ TileSortStorage storage;
  const int m = counts[blockIdx.x];
  if (m == 0) return;
  const int64_t start = starts[blockIdx.x];
  const unsigned long long id_mask = (1ull << id_bits) - 1ull;
  unsigned long long* in = reinterpret_cast<unsigned long long*>(keys) + start;
  unsigned long long* out = reinterpret_cast<unsigned long long*>(packed) + start;
  if (m <= kSortKeys / 2) {
    sort_run<kSortItems / 2>(in, m, end_bit, storage, out, ids + start, id_mask);
    return;
  }
  if (m <= kSortKeys) {
    sort_run<kSortItems>(in, m, end_bit, storage, out, ids + start, id_mask);
    return;
  }
  // a long tile: sorted runs of kSortKeys keys in place, then merges of
  // pairs of runs, each pass from one buffer into the other
  for (int r = 0; r < m; r += kSortKeys) {
    sort_run<kSortItems>(in + r, m - r < kSortKeys ? m - r : kSortKeys, end_bit, storage, in + r, nullptr, 0);
    __syncthreads();
  }
  unsigned long long *src = in, *dst = out;
  const int64_t per_thread = (m + kSortThreads - 1) / kSortThreads;
  for (int64_t width = kSortKeys; width < m; width *= 2) {
    // thread t writes outputs [t * per_thread, + per_thread), a piece per
    // pair of runs it overlaps
    const int64_t end = min64((int64_t)(threadIdx.x + 1) * per_thread, m);
    for (int64_t k = (int64_t)threadIdx.x * per_thread; k < end;) {
      const int64_t lo = k / (2 * width) * (2 * width);
      const int64_t mid = min64(lo + width, m), hi = min64(lo + 2 * width, m), stop = min64(hi, end);
      merge_range(src + lo, mid - lo, src + mid, hi - mid, k - lo, stop - lo, dst + lo);
      k = stop;
    }
    __syncthreads();
    unsigned long long* t = src;
    src = dst;
    dst = t;
  }
  for (int i = threadIdx.x; i < m; i += kSortThreads) {
    const unsigned long long v = src[i];
    if (src != out) out[i] = v;
    ids[start + i] = (int32_t)(v & id_mask);
  }
}

// ---------------------------------------------------------------------------
// K6: saturating blend

struct BlendArgs {
  const float* means2d;  // (N, 2)
  const float* conics;   // (N, 3)
  const float* opac;     // (N,)
  const float* ch;       // (N, 5)
  const int32_t* ids;    // (M,) sorted gaussian ids
  const int32_t* starts;
  const int32_t* counts;
  int tiles_x, width, height;
};

// One tile's entries, staged in shared memory.
struct Staged {
  int32_t id[kThreads];
  float mx[kThreads], my[kThreads];
  float a[kThreads], b[kThreads], c[kThreads];
  float o[kThreads];
  float ch[5][kThreads];
};

__device__ __forceinline__ void stage(Staged& s, int slot, const BlendArgs& args, int32_t gid) {
  s.id[slot] = gid;
  s.mx[slot] = args.means2d[2 * gid];
  s.my[slot] = args.means2d[2 * gid + 1];
  s.a[slot] = args.conics[3 * gid];
  s.b[slot] = args.conics[3 * gid + 1];
  s.c[slot] = args.conics[3 * gid + 2];
  s.o[slot] = args.opac[gid];
  for (int k = 0; k < 5; ++k) s.ch[k][slot] = args.ch[5 * gid + k];
}

// sigma of _alpha_from_gathered: 0.5 (a dx^2 + c dy^2) + b dx dy
__device__ __forceinline__ float gauss_sigma(const Staged& s, int j, float dx, float dy) {
  return 0.5f * (s.a[j] * (dx * dx) + s.c[j] * (dy * dy)) + s.b[j] * dx * dy;
}

// One front-to-back step of a pixel at (px, py) over staged entry j, entry
// `index` of its tile: the reference's mask (sigma >= 0 and alpha > 1/255,
// false for a NaN sigma or a NaN alpha, as jnp.minimum propagates NaN),
// then the blend. Both forward designs take every (pixel, entry) step
// here, so they round alike.
__device__ __forceinline__ void blend_entry(const Staged& s, int j, int index, float px, float py, float& T,
                                            float (&acc)[5], int& last, bool& done) {
  const float dx = px - s.mx[j], dy = py - s.my[j];
  const float sigma = gauss_sigma(s, j, dx, dy);
  if (!(sigma >= 0.0f)) return;
  const float raw = s.o[j] * expf(-sigma);
  if (!(raw > kMinAlpha)) return;  // alpha = min(raw, 0.999) > 1/255 exactly when raw > 1/255
  const float alpha = fminf(kMaxAlpha, raw);
  const float w = alpha * T;
  for (int k = 0; k < 5; ++k) acc[k] += w * s.ch[k][j];
  T = T * (1.0f - alpha);
  last = index + 1;
  if (T < kTransmittanceEps) done = true;
}

// K6 forward, the first design ("per_pixel"): every pixel walks every
// staged entry of its tile until it is done.
__global__ void __launch_bounds__(kThreads) blend_fwd_kernel(BlendArgs args, float* __restrict__ out_ch,
                                                             float* __restrict__ out_T,
                                                             int32_t* __restrict__ out_last) {
  __shared__ Staged s;
  const int tile = blockIdx.x;
  const int tx = tile % args.tiles_x, ty = tile / args.tiles_x;
  const int lx = threadIdx.x % kTile, ly = threadIdx.x / kTile;
  const int x = tx * kTile + lx, y = ty * kTile + ly;
  const bool inside = x < args.width && y < args.height;
  const float px = ((float)lx + 0.5f) + (float)(tx * kTile);
  const float py = ((float)ly + 0.5f) + (float)(ty * kTile);
  const int start = args.starts[tile], count = args.counts[tile];

  float T = 1.0f, acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int last = 0;
  bool done = !inside;
  for (int base = 0; base < count; base += kThreads) {
    // a barrier too: no thread still reads the previous batch
    if (__syncthreads_count(done) == kThreads) break;
    if (base + (int)threadIdx.x < count) stage(s, threadIdx.x, args, args.ids[start + base + threadIdx.x]);
    __syncthreads();
    const int nb = min(kThreads, count - base);
    for (int j = 0; j < nb && !done; ++j) blend_entry(s, j, base + j, px, py, T, acc, last, done);
  }
  if (inside) {
    const int64_t pix = (int64_t)y * args.width + x;
    for (int k = 0; k < 5; ++k) out_ch[5 * pix + k] = acc[k];
    out_T[pix] = T;
    out_last[pix] = last;
  }
}

// K6 forward, the culled design (the default). What bounds the per-pixel
// design: it issues ~35 instructions per (pixel, staged entry), and a warp
// walks every entry of its tile, though many touch only part of the tile
// (alpha <= 1/255 at all 32 of the warp's pixels). Here each staged entry
// also gets a box in pixel space outside which no pixel blends it
// (cull_extents); each warp, which holds an 8 x 4 rectangle of its tile's
// pixels, tests the rectangle against the batch's boxes (a lane tests 8 of
// the 256 entries, one ballot per 32), writes the indices that survive, in
// order, to its own list in shared memory, and walks only that list. A
// skipped entry would have failed the mask at every pixel of the warp, so
// T, the sums and `last` come out bit-equal to the per-pixel design's. The
// done exit and the block's break stay. Measured against the options
// tried (PERF.md): 16 x 2 rectangles cull fewer entries, an extra pixel on
// the box culls fewer, and two pixels per thread, 8-byte staging loads,
// heaviest tiles first, 32 registers, the next index loaded a step ahead
// and a sigma threshold before the exp did not pay.
//
// Why the box is conservative. Let u = 2^-24 and X, Y the float32
// differences px - mx, py - my that blend_entry computes. Without FMA
// contraction (-fmad=false) the computed sigma is within 3u P (1 + u) of
// Q = 0.5 (a X^2 + c Y^2) + b X Y, where P = 0.5 (a X^2 + c Y^2) + |b X Y|.
// For a > 0 and det = a c - b^2 > 0, 0.5 (a X^2 + c Y^2) >= sqrt(a c) |X Y|
// gives P <= Q (1 + r) / (1 - r) = Q (sqrt(a c) + |b|)^2 / det with r =
// |b| / sqrt(a c), so sigma >= Q (1 - kappa) with kappa = kCullKappa
// (sqrt(a c) + |b|)^2 / det (4 u needed, 1e-6 = 16.8 u taken). The alpha
// test fails once sigma >= S0 = log(255 o) + margins (logf and expf are
// within 2 ulp; the margins are 1e-3 relative and 1e-3 absolute), and
// Q >= S0 / (1 - kappa) = S wherever |X| >= sqrt(2 S c / det) or |Y| >=
// sqrt(2 S a / det) (the minimum of Q over Y at fixed X is X^2 det /
// (2 c)). det is taken 1e-6 a c low (its own rounding is <= 3 u a c), the
// extents 1e-3 high. Rounding is monotone, so the rectangle's extreme
// pixels' computed differences bound every pixel's. No box (never culled):
// a non-finite input, a conic that is not positive definite after the det
// margin, or kappa >= 1/2 (along a diagonal, an eigenvalue ratio of ~5
// 10^5: a gaussian 0.55 px wide, as thin as K4's 0.3 px^2 dilation leaves
// one, and ~400 px long). An empty box (always culled): o <= 1/255
// (expf(-sigma) <= 1 for sigma >= 0, so alpha <= o). A NaN sigma or alpha
// fails the mask in both designs (blend_entry).
constexpr float kCullSigmaRel = 1e-3f;
constexpr float kCullSigmaAbs = 1e-3f;
constexpr float kCullDet = 1e-6f;
constexpr float kCullKappa = 1e-6f;
constexpr float kCullExtentScale = 1.001f;
constexpr int kWarps = kThreads / 32;
constexpr int kRectW = 8, kRectH = 4;  // a warp's rectangle of pixels
constexpr int kRectsX = kTile / kRectW;

// The box's half-extents (ex, ey) around (mx, my): a pixel blends the entry
// only where |px - mx| < ex and |py - my| < ey. NaN: no box (never
// culled); -inf: empty (always culled). rasterize._cull_extents is its
// PyTorch twin, op for op.
__device__ __forceinline__ float2 cull_extents(float mx, float my, float a, float b, float c, float o) {
  const float none = __int_as_float(0x7fffffff), inf = __int_as_float(0x7f800000);
  if (!(fabsf(mx) < inf && fabsf(my) < inf && fabsf(a) < inf && fabsf(b) < inf && fabsf(c) < inf && fabsf(o) < inf))
    return make_float2(none, none);
  const float ac = a * c;
  const float det_lo = (ac - b * b) - kCullDet * ac;
  if (!(a > 0.0f && c > 0.0f && det_lo > 0.0f)) return make_float2(none, none);
  if (!(o > kMinAlpha)) return make_float2(-inf, -inf);
  float s0 = logf(o * 255.0f);
  s0 = (s0 + kCullSigmaRel * fabsf(s0)) + kCullSigmaAbs;
  const float amp = sqrtf(ac) + fabsf(b);
  const float kappa = kCullKappa * (amp * amp / det_lo);
  if (!(kappa < 0.5f)) return make_float2(none, none);
  const float s = s0 / (1.0f - kappa);
  return make_float2(sqrtf(2.0f * s * c / det_lo) * kCullExtentScale, sqrtf(2.0f * s * a / det_lo) * kCullExtentScale);
}

// The culled design's shared state besides the staged entries: each staged
// entry's box, and each warp's list of the entries it walks.
struct CullLists {
  float2 ext[kThreads];
  uint16_t list[kWarps][kThreads];
};

__global__ void __launch_bounds__(kThreads) blend_fwd_culled_kernel(BlendArgs args, float* __restrict__ out_ch,
                                                                    float* __restrict__ out_T,
                                                                    int32_t* __restrict__ out_last) {
  __shared__ Staged s;
  __shared__ CullLists cl;
  const int tile = blockIdx.x;
  const int tx = tile % args.tiles_x, ty = tile / args.tiles_x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int col0 = (warp % kRectsX) * kRectW, row0 = (warp / kRectsX) * kRectH;  // the warp's rectangle
  const int lx = col0 + lane % kRectW, ly = row0 + lane / kRectW;
  const int x = tx * kTile + lx, y = ty * kTile + ly;
  const bool inside = x < args.width && y < args.height;
  const float px = ((float)lx + 0.5f) + (float)(tx * kTile);
  const float py = ((float)ly + 0.5f) + (float)(ty * kTile);
  const int start = args.starts[tile], count = args.counts[tile];
  // the rectangle's extreme pixel centres, computed as its pixels' are
  const float px_lo = ((float)col0 + 0.5f) + (float)(tx * kTile);
  const float px_hi = ((float)(col0 + kRectW - 1) + 0.5f) + (float)(tx * kTile);
  const float py_lo = ((float)row0 + 0.5f) + (float)(ty * kTile);
  const float py_hi = ((float)(row0 + kRectH - 1) + 0.5f) + (float)(ty * kTile);

  float T = 1.0f, acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int last = 0;
  bool done = !inside;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < count; base += kThreads) {
    // a barrier too: no thread still reads the previous batch or list
    if (__syncthreads_count(done) == kThreads) break;
    if (base + (int)threadIdx.x < count) {
      const int t = threadIdx.x;
      stage(s, t, args, args.ids[start + base + t]);
      cl.ext[t] = cull_extents(s.mx[t], s.my[t], s.a[t], s.b[t], s.c[t], s.o[t]);
    }
    __syncthreads();
    const int nb = min(kThreads, count - base);
    int n = 0;
    if (!__all_sync(0xffffffffu, done)) {
      for (int j0 = 0; j0 < nb; j0 += 32) {
        const int j = j0 + lane;
        bool keep = false;
        if (j < nb) {
          const float2 e = cl.ext[j];
          const float mx = s.mx[j], my = s.my[j];
          keep = !((px_lo - mx >= e.x) || (px_hi - mx <= -e.x) || (py_lo - my >= e.y) || (py_hi - my <= -e.y));
        }
        const unsigned m = __ballot_sync(0xffffffffu, keep);
        if (keep) cl.list[warp][n + __popc(m & below)] = (uint16_t)j;
        n += __popc(m);
      }
      __syncwarp();
    }
    for (int i = 0; i < n && !done; ++i) {
      const int j = cl.list[warp][i];
      blend_entry(s, j, base + j, px, py, T, acc, last, done);
    }
  }
  if (inside) {
    const int64_t pix = (int64_t)y * args.width + x;
    for (int k = 0; k < 5; ++k) out_ch[5 * pix + k] = acc[k];
    out_T[pix] = T;
    out_last[pix] = last;
  }
}

// One stage of the warp's multi-value butterfly: a lane holding 2N partial
// sums keeps the upper half if its bit 2N is set (else the lower), sends
// the other half to the lane 2N away and adds what that lane sent.
template <int N>
__device__ __forceinline__ void butterfly_stage(float (&a)[16], int lane) {
  const bool upper = (lane & (2 * N)) != 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = upper ? a[i] : a[N + i];
    const float keep = upper ? a[N + i] : a[i];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * N);
  }
}

// The warp's sums of d[0..10] in 16 shuffles: lanes 2c and 2c + 1 return
// the sum of d[c] (c < 11; lanes 22-31 the sums of the zero padding).
__device__ __forceinline__ float warp_sum11(const float (&d)[kGradStride], int lane) {
  float a[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) a[k] = k < kGradStride ? d[k] : 0.0f;
  butterfly_stage<8>(a, lane);
  butterfly_stage<4>(a, lane);
  butterfly_stage<2>(a, lane);
  butterfly_stage<1>(a, lane);
  return a[0] + __shfl_xor_sync(0xffffffffu, a[0], 1);
}

// The 11 gradient values of one (pixel, entry j of the staged batch), or
// false where the pixel did not blend it: the back-to-front step of the
// replay, updating the pixel's T (to the transmittance in front of the
// entry) and its suffix sum.
__device__ __forceinline__ bool replay_entry(const Staged& s, int j, float px, float py, const float (&g)[5],
                                             float& T, float& suffix, float (&d)[kGradStride]) {
  const float dx = px - s.mx[j], dy = py - s.my[j];
  const float sigma = gauss_sigma(s, j, dx, dy);
  if (!(sigma >= 0.0f)) return false;  // the forward's mask (blend_entry)
  const float vis = expf(-sigma);
  const float raw = s.o[j] * vis;
  if (!(raw > kMinAlpha)) return false;
  const float alpha = fminf(kMaxAlpha, raw);
  const float one_m = 1.0f - alpha;
  T = T / one_m;  // transmittance in front of this entry
  float G = 0.0f;
  for (int k = 0; k < 5; ++k) G += g[k] * s.ch[k][j];
  const float w = alpha * T;
  const float d_alpha = T * G - suffix / one_m;
  suffix += w * G;
  for (int k = 0; k < 5; ++k) d[5 + k] = w * g[k];
  const float d_raw = d_alpha * dmin(raw, kMaxAlpha);
  d[10] = d_raw * vis;
  const float d_sigma = -d_raw * raw;
  d[2] = d_sigma * 0.5f * (dx * dx);
  d[3] = d_sigma * dx * dy;
  d[4] = d_sigma * 0.5f * (dy * dy);
  d[0] = -d_sigma * (s.a[j] * dx + s.b[j] * dy);
  d[1] = -d_sigma * (s.c[j] * dy + s.b[j] * dx);
  return true;
}

__global__ void __launch_bounds__(kThreads) blend_bwd_kernel(BlendArgs args, const float* __restrict__ T_final,
                                                             const int32_t* __restrict__ last_entry,
                                                             const float* __restrict__ g_ch,
                                                             float* __restrict__ grads) {
  __shared__ Staged s;
  __shared__ float acc[kThreads * kGradStride];  // acc[j * 11 + c]: value c of staged entry j, over the tile
  __shared__ int block_last;
  const int tile = blockIdx.x;
  const int tx = tile % args.tiles_x, ty = tile / args.tiles_x;
  const int lx = threadIdx.x % kTile, ly = threadIdx.x / kTile;
  const int lane = threadIdx.x % 32;
  const int x = tx * kTile + lx, y = ty * kTile + ly;
  const bool inside = x < args.width && y < args.height;
  const float px = ((float)lx + 0.5f) + (float)(tx * kTile);
  const float py = ((float)ly + 0.5f) + (float)(ty * kTile);
  const int start = args.starts[tile];
  const int64_t pix = (int64_t)y * args.width + x;

  float T = inside ? T_final[pix] : 1.0f;
  const int last = inside ? last_entry[pix] : 0;
  float g[5];
  for (int k = 0; k < 5; ++k) g[k] = inside ? g_ch[5 * pix + k] : 0.0f;
  float suffix = 0.0f;  // sum over the later blended entries of w * (g . ch)

  for (int e = threadIdx.x; e < kThreads * kGradStride; e += kThreads) acc[e] = 0.0f;
  if (threadIdx.x == 0) block_last = 0;
  __syncthreads();
  const int warp_last = (int)__reduce_max_sync(0xffffffffu, (unsigned)last);
  if (lane == 0) atomicMax(&block_last, warp_last);
  __syncthreads();
  const int end_all = block_last;

  for (int end = end_all; end > 0; end -= kThreads) {
    const int b0 = max(0, end - kThreads);
    const int nb = end - b0;
    __syncthreads();  // no thread still reads the previous batch or flushes its sums
    if ((int)threadIdx.x < nb) stage(s, threadIdx.x, args, args.ids[start + b0 + threadIdx.x]);
    __syncthreads();
    // the warp's own entries of the batch: none at or past its largest last
    for (int j = min(end, warp_last) - b0 - 1; j >= 0; --j) {
      float d[kGradStride];
      const bool hit = b0 + j < last && replay_entry(s, j, px, py, g, T, suffix, d);
      if (!__any_sync(0xffffffffu, hit)) continue;
      if (!hit)
        for (int k = 0; k < kGradStride; ++k) d[k] = 0.0f;
      const float sum = warp_sum11(d, lane);
      if ((lane & 1) == 0 && lane < 2 * kGradStride) atomicAdd(&acc[j * kGradStride + lane / 2], sum);
    }
    __syncthreads();  // every warp's sums are in
    for (int e = threadIdx.x; e < nb * kGradStride; e += kThreads) {
      const float v = acc[e];
      if (v != 0.0f) {
        const int j = e / kGradStride;
        atomicAdd(grads + (int64_t)kGradStride * s.id[j] + (e - j * kGradStride), v);
        acc[e] = 0.0f;
      }
    }
  }
}

unsigned int grid_for(int64_t work) { return (unsigned int)((work + kThreads - 1) / kThreads); }

Camera make_camera(const float* params, int width, int height, int antialiased) {
  // params: viewmat rows 0-2 (12 floats, [R | t]), fx, fy, cx, cy, lim_x,
  // lim_y, near, eps2d
  Camera cam;
  for (int r = 0; r < 3; ++r) {
    for (int k = 0; k < 3; ++k) cam.R[3 * r + k] = params[4 * r + k];
    cam.t[r] = params[4 * r + 3];
  }
  cam.fx = params[12];
  cam.fy = params[13];
  cam.cx = params[14];
  cam.cy = params[15];
  cam.lim_x = params[16];
  cam.lim_y = params[17];
  cam.near_plane = params[18];
  cam.eps2d = params[19];
  cam.width = width;
  cam.height = height;
  cam.antialiased = antialiased;
  return cam;
}

BlendArgs make_blend_args(const void* means2d, const void* conics, const void* opac, const void* ch,
                          const void* ids, const void* starts, const void* counts, int tiles_x, int width,
                          int height) {
  BlendArgs a;
  a.means2d = (const float*)means2d;
  a.conics = (const float*)conics;
  a.opac = (const float*)opac;
  a.ch = (const float*)ch;
  a.ids = (const int32_t*)ids;
  a.starts = (const int32_t*)starts;
  a.counts = (const int32_t*)counts;
  a.tiles_x = tiles_x;
  a.width = width;
  a.height = height;
  return a;
}

// K5's emission arguments, checked: means2d (n, 2), radii, depths (n,)
// f32 and valid (n,) uint8 device inputs; idx_big (n_big,) int64, the big
// window's gaussians; fewer than 2^31 pairs.
cudaError_t make_emission(const void* means2d, const void* radii, const void* depths, const void* valid,
                          long long n, const void* idx_big, long long n_big, int tiles_x, int tiles_y, int d,
                          int d_big, int depth_bits, int id_bits, Emission* e) {
  if (n < 1 || n_big < 0 || (n_big > 0 && idx_big == nullptr) || d < 1 || d_big < 1 || depth_bits < 1 ||
      id_bits < 1 || 32 + id_bits > 63 || tiles_x < 1 || tiles_y < 1 ||
      (int64_t)d * d * n + (int64_t)d_big * d_big * n_big >= (1LL << 31))
    return cudaErrorInvalidValue;
  *e = {(const float*)means2d, (const float*)radii, (const float*)depths, (const uint8_t*)valid, n,
        (const int64_t*)idx_big, n_big, {tiles_x, tiles_y, tiles_x * tiles_y, depth_bits, id_bits}, d, d_big};
  return cudaSuccess;
}

// project_bwd_kernel's persistent grid on the current device: the blocks
// of that instance resident on one SM at once times the SMs, cached per
// device (0 if the runtime cannot say).
constexpr int kMaxDevices = 64;

template <bool kDevView, bool kGradView>
int64_t bwd_grid_limit() {
  static int cache[kMaxDevices] = {0};
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, project_bwd_kernel<kDevView, kGradView>, kThreads, 0) !=
          cudaSuccess)
    return 0;
  if (dev < kMaxDevices) cache[dev] = sms * per_sm;
  return (int64_t)sms * per_sm;
}

}  // namespace

extern "C" {

// K4 forward. means, scales (n, 3) and quats (n, 4) are f32 device inputs
// (scales linear, quats wxyz, any norm); cam is a host array of 20 floats
// (see make_camera); view, when not null, is a device array of 12 floats
// (viewmat rows 0-2, row-major) that replaces cam's first 12. Outputs:
// means2d (n, 2), depths (n,), conics (n, 3), radii (n,) f32, valid (n,)
// uint8 and comp (n,) f32, the antialiasing compensation (1 unless
// antialiased). Returns a cudaError_t (0 on success).
int nst_gsplat_project_fwd(const void* means, const void* scales, const void* quats, const float* cam,
                           const void* view, int width, int height, int antialiased, long long n, void* means2d,
                           void* depths, void* conics, void* radii, void* valid, void* comp, void* stream) {
  if (n < 0 || width < 1 || height < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const Camera c = make_camera(cam, width, height, antialiased);
  auto kernel = view ? project_fwd_kernel<true> : project_fwd_kernel<false>;
  kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)means, (const float*)scales, (const float*)quats, n, c, (const float*)view, (float*)means2d,
      (float*)depths, (float*)conics, (float*)radii, (uint8_t*)valid, (float*)comp);
  return (int)cudaGetLastError();
}

// The floats of device scratch that nst_gsplat_project_bwd needs on the
// current device to sum d(viewmat): a 12-float partial per block of its
// largest grid, then the ticket (a zeroed uint32) and padding. The scratch
// is zeroed once and serves every later call on one stream.
long long nst_gsplat_project_bwd_scratch(void) {
  const int64_t limit = bwd_grid_limit<true, true>();
  return limit > 0 ? 12 * limit + 4 : 0;
}

// K4 backward: the cotangents d_means2d (n, 2), d_depths (n,), d_conics
// (n, 3) and d_comp (n,) (read only when antialiased) in; d_means (n, 3),
// d_scales (n, 3), d_quats (n, 4) out (every row written; quats and d_quats
// 16-byte aligned); cam and view as the forward's, view (when not null) the
// first 12 floats of the row-major (4, 4) viewmat. With d_view not null
// (then view and scratch must not be null either) the same launch also
// writes d(viewmat) into d_view, 16 floats (4, 4), its last row zero,
// through scratch (nst_gsplat_project_bwd_scratch() floats, zeroed before
// its first use). Returns a cudaError_t.
int nst_gsplat_project_bwd(const void* means, const void* scales, const void* quats, const float* cam,
                           const void* view, int width, int height, int antialiased, long long n,
                           const void* d_means2d, const void* d_depths, const void* d_conics, const void* d_comp,
                           void* d_means, void* d_scales, void* d_quats, void* scratch, void* d_view, void* stream) {
  if (n < 0 || width < 1 || height < 1 || (d_view && (!view || !scratch)) || ((uintptr_t)quats & 15) ||
      ((uintptr_t)d_quats & 15))
    return (int)cudaErrorInvalidValue;
  if (n == 0 && !d_view) return (int)cudaSuccess;
  const Camera c = make_camera(cam, width, height, antialiased);
  auto kernel = d_view ? project_bwd_kernel<true, true>
                       : (view ? project_bwd_kernel<true, false> : project_bwd_kernel<false, false>);
  const int64_t limit = d_view ? bwd_grid_limit<true, true>()
                               : (view ? bwd_grid_limit<true, false>() : bwd_grid_limit<false, false>());
  if (limit <= 0) return (int)cudaErrorInvalidConfiguration;
  const int64_t tiles = (n + kThreads - 1) / kThreads;
  const unsigned int grid = (unsigned int)(tiles < 1 ? 1 : (tiles < limit ? tiles : limit));
  float* partials = (float*)scratch;
  unsigned int* ticket = d_view ? (unsigned int*)(partials + 12 * limit) : nullptr;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)means, (const float*)scales, (const float4*)quats, n, c, (const float*)view,
      (const float*)d_means2d, (const float*)d_depths, (const float*)d_conics, (const float*)d_comp, (float*)d_means,
      (float*)d_scales, (float4*)d_quats, partials, ticket, (float*)d_view);
  return (int)cudaGetLastError();
}

// K5's first design, its emission (make_emission's inputs). out
// (d*d*n + d_big*d_big*n_big,) int64 receives every pair's packed key, a
// dead slot's with tile num_tiles. Returns a cudaError_t.
int nst_gsplat_tile_keys(const void* means2d, const void* radii, const void* depths, const void* valid,
                         long long n, const void* idx_big, long long n_big, int tiles_x, int tiles_y, int d,
                         int d_big, int depth_bits, int id_bits, void* out, void* stream) {
  Emission e;
  const cudaError_t bad = make_emission(means2d, radii, depths, valid, n, idx_big, n_big, tiles_x, tiles_y, d, d_big,
                                        depth_bits, id_bits, &e);
  if (bad != cudaSuccess) return (int)bad;
  tile_keys_kernel<<<grid_for(pair_count(e)), kThreads, 0, (cudaStream_t)stream>>>(e, (int64_t*)out);
  return (int)cudaGetLastError();
}

// K5's second design (tile-bucketed), make_emission's inputs. counts,
// starts and cursor (tiles_x * tiles_y,) int32 and keys, packed (pairs,)
// int64 and ids (pairs,) int32 are device buffers; starts, counts and the
// first counts.sum() entries of packed and ids receive the bins (the rest
// is not written), cursor and keys are scratch. sort_keys: the keys one
// block sorts at once, which must be kSortKeys (rasterize.TILE_SORT_KEYS);
// the histograms take 4 bytes per tile, at most kMaxSharedBytes. Returns
// a cudaError_t.
int nst_gsplat_tile_bin(const void* means2d, const void* radii, const void* depths, const void* valid, long long n,
                        const void* idx_big, long long n_big, int tiles_x, int tiles_y, int d, int d_big,
                        int depth_bits, int id_bits, int sort_keys, void* counts, void* starts, void* cursor,
                        void* keys, void* packed, void* ids, void* stream) {
  Emission e;
  cudaError_t err = make_emission(means2d, radii, depths, valid, n, idx_big, n_big, tiles_x, tiles_y, d, d_big,
                                  depth_bits, id_bits, &e);
  if (err != cudaSuccess) return (int)err;
  const int nt = e.tg.num_tiles;
  const int hist_bytes = nt * 4;
  if ((int64_t)nt * 4 > kMaxSharedBytes || sort_keys != kSortKeys) return (int)cudaErrorInvalidValue;
  // once per process (the port drives one card): the histograms' opt-in
  // above 48 KB, the SMs
  static int sms = 0;
  if (sms == 0) {
    const void* kernels[] = {(const void*)tile_count_kernel, (const void*)tile_scatter_kernel};
    for (const void* k : kernels) {
      if ((err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSharedBytes)) != cudaSuccess)
        return (int)err;
    }
    int dev;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)err;
  }
  // the binning passes: one thread per unit (gaussian or big-window
  // gaussian), at most as many blocks as fit on the card at once
  int per_sm;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tile_scatter_kernel, kBinThreads, hist_bytes)) !=
      cudaSuccess)
    return (int)err;
  const int64_t needed = (e.n + e.n_big + kBinThreads - 1) / kBinThreads;
  const int64_t fit = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned int grid = (unsigned int)(needed < fit ? needed : fit);
  const cudaStream_t s = (cudaStream_t)stream;
  int32_t* c = (int32_t*)counts;
  if ((err = cudaMemsetAsync(c, 0, (size_t)hist_bytes, s)) != cudaSuccess) return (int)err;
  tile_count_kernel<<<grid, kBinThreads, hist_bytes, s>>>(e, c);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tile_scan_kernel<<<1, kBinThreads, 0, s>>>(c, nt, (int32_t*)starts, (int32_t*)cursor);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tile_scatter_kernel<<<grid, kBinThreads, hist_bytes, s>>>(e, (int32_t*)cursor, (int64_t*)keys);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tile_sort_kernel<<<nt, kSortThreads, 0, s>>>((const int32_t*)starts, c, (int64_t*)keys, (int64_t*)packed,
                                                (int32_t*)ids, e.tg.depth_bits + e.tg.id_bits, e.tg.id_bits);
  return (int)cudaGetLastError();
}

// K5 ranges. packed (m,) int64 sorted ascending; ids (m,), starts and counts
// (tiles_x * tiles_y,) int32 out. Returns a cudaError_t.
int nst_gsplat_tile_ranges(const void* packed, long long m, int tiles_x, int tiles_y, int depth_bits,
                           int id_bits, void* ids, void* starts, void* counts, void* stream) {
  if (m < 0 || m > 0x7FFFFFFFLL || tiles_x < 1 || tiles_y < 1) return (int)cudaErrorInvalidValue;
  const TileGrid tg = {tiles_x, tiles_y, tiles_x * tiles_y, depth_bits, id_bits};
  const int64_t work = m > tg.num_tiles ? m : tg.num_tiles;
  tile_ranges_kernel<<<grid_for(work), kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)packed, m, tg, (int32_t*)ids, (int32_t*)starts, (int32_t*)counts);
  return (int)cudaGetLastError();
}

// K6 forward. means2d (N, 2), conics (N, 3), opac (N,), ch (N, 5) f32 and
// ids (M,), starts, counts (tiles,) int32 are device inputs. Outputs over
// the image: out_ch (height, width, 5), out_T (height, width) f32 and
// out_last (height, width) int32. design: 1 the culled design, 0 the
// per-pixel one. Returns a cudaError_t.
int nst_gsplat_blend_fwd(const void* means2d, const void* conics, const void* opac, const void* ch,
                         const void* ids, const void* starts, const void* counts, int tiles_x, int tiles_y,
                         int width, int height, int design, void* out_ch, void* out_T, void* out_last,
                         void* stream) {
  if (tiles_x < 1 || tiles_y < 1 || width < 1 || height < 1 || width > tiles_x * kTile ||
      height > tiles_y * kTile || (design != 0 && design != 1))
    return (int)cudaErrorInvalidValue;
  const BlendArgs args = make_blend_args(means2d, conics, opac, ch, ids, starts, counts, tiles_x, width, height);
  const int nt = tiles_x * tiles_y;
  if (design == 1)
    blend_fwd_culled_kernel<<<nt, kThreads, 0, (cudaStream_t)stream>>>(args, (float*)out_ch, (float*)out_T,
                                                                        (int32_t*)out_last);
  else
    blend_fwd_kernel<<<nt, kThreads, 0, (cudaStream_t)stream>>>(args, (float*)out_ch, (float*)out_T,
                                                                 (int32_t*)out_last);
  return (int)cudaGetLastError();
}

// K6 backward. The forward's inputs, its T_final and last outputs and the
// cotangent g_ch (height, width, 5) in; grads (N, 11) f32, zeroed by the
// caller, accumulates [d means2d (2), d conics (3), d ch (5), d opac].
// Returns a cudaError_t.
int nst_gsplat_blend_bwd(const void* means2d, const void* conics, const void* opac, const void* ch,
                         const void* ids, const void* starts, const void* counts, int tiles_x, int tiles_y,
                         int width, int height, const void* T_final, const void* last, const void* g_ch,
                         void* grads, void* stream) {
  if (tiles_x < 1 || tiles_y < 1 || width < 1 || height < 1 || width > tiles_x * kTile ||
      height > tiles_y * kTile)
    return (int)cudaErrorInvalidValue;
  blend_bwd_kernel<<<tiles_x * tiles_y, kThreads, 0, (cudaStream_t)stream>>>(
      make_blend_args(means2d, conics, opac, ch, ids, starts, counts, tiles_x, width, height),
      (const float*)T_final, (const int32_t*)last, (const float*)g_ch, (float*)grads);
  return (int)cudaGetLastError();
}

const char* nst_gsplat_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
