// Direct-space cell-pair sweep, forces only: the Hopper counterpart of the
// TPU kernel ops/pallas_sweep.py::pair_forces_pallas in the JAX package.
//
// Physics: LJ with Lorentz sigma and Berthelot sqrt(eps) product, plus
// Ewald real-space Coulomb with the Abramowitz & Stegun 7.1.26 erfc (the
// same polynomial as the TPU kernel, so the two agree term for term).
// Pairs: the home cell against itself (a != b, row forces only) and the
// half stencil of neighbour cells, each pair's reaction credited to the
// neighbour slot (Newton's third law).  Cutoff test, r^2 clamp 1e-6, a
// one-word exclusion bitmask over atom-index differences within W, tested
// only at offsets flagged in `check_excl`.
//
// Design: one CTA per home cell, one thread per home slot.  Each stencil
// neighbour's occupied slots are staged in shared memory; every thread
// walks them, keeps its row force in registers, and the per-neighbour
// reactions are summed across each warp with shuffles and added to a
// shared buffer, which goes to device memory with one atomicAdd per slot
// and component.  What bounds it: the pair arithmetic (~5e8 pair tests at
// the 100k-atom bench size, 15^3 cells, C = 48, 63 offsets) — the inputs
// are a few MB.  A later version can tile several home cells per CTA and
// drop the warp reductions.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCap = 128;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void sweep_forces_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ z, const float* __restrict__ q,
    const float* __restrict__ sig, const float* __restrict__ seps,
    const int* __restrict__ gid, const int* __restrict__ ew,
    const int* __restrict__ count, const int* __restrict__ nbr,
    const float* __restrict__ shift, const int* __restrict__ check_excl,
    float* __restrict__ f, int cap, int n_off, float cutoff2, float alpha,
    float coulomb_scale, int excl_window) {
  __shared__ float sx[kMaxCap], sy[kMaxCap], sz[kMaxCap], sq[kMaxCap];
  __shared__ float ssig[kMaxCap], sseps[kMaxCap];
  __shared__ int sgid[kMaxCap];
  __shared__ float rx[kMaxCap], ry[kMaxCap], rz[kMaxCap];

  const int cell = blockIdx.x;
  const int a = threadIdx.x;
  const int lane = a & 31;
  const int na = count[cell];
  const bool active = a < na;
  const int sa = cell * cap + a;
  const float xa = active ? x[sa] : 0.f;
  const float ya = active ? y[sa] : 0.f;
  const float za = active ? z[sa] : 0.f;
  const float qa = active ? coulomb_scale * q[sa] : 0.f;
  const float siga = active ? sig[sa] : 1.f;
  const float sepsa = active ? seps[sa] : 0.f;
  const int gida = active ? gid[sa] : -1;
  const int ewa = active ? ew[sa] : 0;
  const float two_over_sqrt_pi = 1.1283791670955126f;

  float fx = 0.f, fy = 0.f, fz = 0.f;
  for (int o = 0; o < n_off; ++o) {
    const int bc = nbr[cell * n_off + o];
    const int nb = count[bc];
    const float tx = shift[3 * o], ty = shift[3 * o + 1],
                tz = shift[3 * o + 2];
    const bool self = (o == 0);
    const bool chk = check_excl[o] != 0 && excl_window > 0;
    __syncthreads();
    for (int s = threadIdx.x; s < nb; s += blockDim.x) {
      const int sb = bc * cap + s;
      sx[s] = x[sb] + tx;
      sy[s] = y[sb] + ty;
      sz[s] = z[sb] + tz;
      sq[s] = q[sb];
      ssig[s] = sig[sb];
      sseps[s] = seps[sb];
      sgid[s] = gid[sb];
      rx[s] = 0.f;
      ry[s] = 0.f;
      rz[s] = 0.f;
    }
    __syncthreads();
    for (int b = 0; b < nb; ++b) {
      const float dx = xa - sx[b];
      const float dy = ya - sy[b];
      const float dz = za - sz[b];
      // unfused, in the plain version's order: the cutoff test then
      // decides every pair exactly as the plain version does
      const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      bool keep = active && r2 < cutoff2 && !(self && b == a);
      if (chk) {
        const int dg = sgid[b] - gida;
        if (dg <= excl_window && dg >= -excl_window &&
            ((ewa >> (dg + excl_window)) & 1))
          keep = false;
      }
      float g2 = 0.f;
      if (keep) {
        const float r2s = fmaxf(r2, 1e-6f);
        const float inv_r = rsqrtf(r2s);
        const float inv_r2 = inv_r * inv_r;
        const float qq = qa * sq[b];
        const float sg = 0.5f * (siga + ssig[b]);
        const float ep = sepsa * sseps[b];
        const float s2 = sg * sg * inv_r2;
        const float x6 = s2 * s2 * s2;
        const float g_lj = -4.f * ep * (6.f * x6 * x6 - 3.f * x6) * inv_r2;
        const float ar = alpha * r2s * inv_r;
        const float t = 1.f / (1.f + 0.3275911f * ar);
        const float expm = expf(-ar * ar);
        const float erfc_ar =
            t * (0.254829592f +
                 t * (-0.284496736f +
                      t * (1.421413741f +
                           t * (-1.453152027f + t * 1.061405429f)))) *
            expm;
        const float g_c = -0.5f * qq * inv_r2 *
                          (erfc_ar * inv_r + two_over_sqrt_pi * alpha * expm);
        g2 = -2.f * (g_lj + g_c);
      }
      const float px = g2 * dx, py = g2 * dy, pz = g2 * dz;
      fx += px;
      fy += py;
      fz += pz;
      if (!self) {
        const float sxr = warp_sum(px), syr = warp_sum(py),
                    szr = warp_sum(pz);
        if (lane == 0) {
          atomicAdd(&rx[b], -sxr);
          atomicAdd(&ry[b], -syr);
          atomicAdd(&rz[b], -szr);
        }
      }
    }
    if (!self) {
      __syncthreads();
      for (int s = threadIdx.x; s < nb; s += blockDim.x) {
        float* fb = f + 3 * (bc * cap + s);
        atomicAdd(fb, rx[s]);
        atomicAdd(fb + 1, ry[s]);
        atomicAdd(fb + 2, rz[s]);
      }
    }
  }
  if (active) {
    atomicAdd(&f[3 * sa], fx);
    atomicAdd(&f[3 * sa + 1], fy);
    atomicAdd(&f[3 * sa + 2], fz);
  }
}

}  // namespace

extern "C" int sweep_max_capacity() { return kMaxCap; }

extern "C" int sweep_forces(const void* x, const void* y, const void* z,
                            const void* q, const void* sig, const void* seps,
                            const void* gid, const void* ew,
                            const void* count, const void* nbr,
                            const void* shift, const void* check_excl,
                            void* f, int n_cells, int cap, int n_off,
                            float cutoff2, float alpha, float coulomb_scale,
                            int excl_window, void* stream) {
  if (cap < 1 || cap > kMaxCap || n_cells < 1 || n_off < 1)
    return (int)cudaErrorInvalidValue;
  const int threads = ((cap + 31) / 32) * 32;
  sweep_forces_kernel<<<n_cells, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (const float*)z, (const float*)q,
      (const float*)sig, (const float*)seps, (const int*)gid,
      (const int*)ew, (const int*)count, (const int*)nbr,
      (const float*)shift, (const int*)check_excl, (float*)f, cap, n_off,
      cutoff2, alpha, coulomb_scale, excl_window);
  return (int)cudaGetLastError();
}
