// Chunked direct-space cell-pair sweep, forces only, with deterministic
// reactions: the Hopper counterpart of the TPU kernel
// ops/pallas_sweep.py::pair_forces_pallas_chunked in the JAX package.
//
// It computes what kernel B1 (csrc/sweep.cu) computes, pair for pair:
// LJ with Lorentz sigma and Berthelot sqrt(eps) product plus Ewald
// real-space Coulomb with the Abramowitz & Stegun 7.1.26 erfc, the home
// cell against itself (row forces only) and the half stencil with Newton
// reactions, cutoff test on an unfused r^2 in the plain version's order,
// r^2 clamp 1e-6, and a one-word exclusion bitmask tested only at offsets
// flagged in `check_excl`.
//
// What differs is where the reactions go.  The TPU kernel runs a
// (x-layer, y-chunk) program grid; each program writes its reactions into
// a frame block of its own and XLA overlap-adds the blocks afterwards, so
// no program scatters into another's output.  Here:
//
//  * A chunk is a brick of bx*by*bz home cells, one CTA.  One warp per
//    32 home slots of one home cell (ceil(C/32) warps a cell), one thread
//    per home slot.  Per stencil offset the CTA stages the occupied slots
//    of every home cell's neighbour in shared memory.
//  * The chunk's frame is the brick grown by the stencil's span: every
//    cell that a home cell or its half stencil touches.  It lives in
//    shared memory.  Per offset and neighbour slot a warp sums the
//    reaction with shuffles and stores it in its own row of a partial
//    buffer; after a barrier one thread per (home cell, slot, component)
//    adds the parts, in part order, into the frame cell home + offset.
//    Home cells map to distinct frame cells at one offset, so every frame
//    entry has one writer per offset and the order is fixed.  At the end
//    each thread adds its row force into its home cell's frame entry.
//  * The frame goes to the chunk's private block of device memory with
//    plain stores: no global atomics, no chunk writes another's block.
//  * overlap_add_kernel then gives each slot the sum of every frame entry
//    that covers its cell, in a fixed order (per-dimension tables of
//    (chunk, frame-local index) built by ops/sweep_chunked.py).
//
// Every sum runs in an order fixed by the data layout, so two launches on
// the same inputs give bit-identical forces (B1's global atomicAdd does
// not).  What bounds it: the pair arithmetic, as B1 (~2e9 pair tests at
// 1M atoms, 33^3 cells, C = 48, 63 offsets); the frames add ~0.4 GB of
// device-memory traffic at that size.  The brick comes from the wrapper
// (ops/sweep_chunked.py::choose_brick: the most warps resident on an SM
// within 227 KB of shared memory a CTA); the frame's shared memory is
// what limits the CTAs an SM holds.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCap = 128;

struct Plan {
  int gx, gy, gz;     // cell grid
  int bx, by, bz;     // home cells per chunk in each dimension
  int nbx, nby, nbz;  // chunks per dimension
  int lox, loy, loz;  // lowest stencil offset per dimension
  int fx, fy, fz;     // frame cells per dimension: brick + stencil span
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// v + o wrapped into [0, g), for |o| < g
__device__ __forceinline__ int wrap(int v, int g) {
  return v < 0 ? v + g : (v >= g ? v - g : v);
}

__global__ void chunk_sweep_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ z, const float* __restrict__ q,
    const float* __restrict__ sig, const float* __restrict__ seps,
    const int* __restrict__ gid, const int* __restrict__ ew,
    const int* __restrict__ count, const int* __restrict__ offsets,
    const float* __restrict__ shift, const int* __restrict__ check_excl,
    float* __restrict__ frames, Plan p, int cap, int n_off, float cutoff2,
    float alpha, float coulomb_scale, int excl_window) {
  extern __shared__ float smem[];
  const int nh = p.bx * p.by * p.bz;
  const int nf = p.fx * p.fy * p.fz;
  const int parts = (cap + 31) >> 5;
  const int fstride = 3 * cap;                   // floats per frame cell
  float* fr = smem;                              // (nf, 3, cap) the frame
  float* part = fr + nf * fstride;               // (parts, nh, 3, cap)
  float* sx = part + parts * nh * fstride;       // (nh, cap) staged slots
  float* sy = sx + nh * cap;
  float* sz = sy + nh * cap;
  float* sq = sz + nh * cap;
  float* ssig = sq + nh * cap;
  float* sseps = ssig + nh * cap;
  int* sgid = reinterpret_cast<int*>(sseps + nh * cap);
  int* snb = sgid + nh * cap;                    // (nh,) neighbour counts
  int* shome = snb + nh;                         // (nh,) home counts

  const int chunk = blockIdx.x;
  const int x0 = (chunk / (p.nby * p.nbz)) * p.bx;
  const int y0 = ((chunk / p.nbz) % p.nby) * p.by;
  const int z0 = (chunk % p.nbz) * p.bz;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = warp / parts;                    // brick-local home cell
  const int wpart = warp - h * parts;
  const int a = wpart * 32 + lane;               // home slot
  const int hx = h / (p.by * p.bz), hy = (h / p.bz) % p.by, hz = h % p.bz;
  const int cx = x0 + hx, cy = y0 + hy, cz = z0 + hz;
  const bool home_ok = cx < p.gx && cy < p.gy && cz < p.gz;
  const int na = home_ok ? count[(cx * p.gy + cy) * p.gz + cz] : 0;
  const bool live = wpart * 32 < na;             // warp-uniform
  const bool active = a < na;
  const int sa = ((cx * p.gy + cy) * p.gz + cz) * cap + a;
  const float xa = active ? x[sa] : 0.f;
  const float ya = active ? y[sa] : 0.f;
  const float za = active ? z[sa] : 0.f;
  const float qa = active ? coulomb_scale * q[sa] : 0.f;
  const float siga = active ? sig[sa] : 1.f;
  const float sepsa = active ? seps[sa] : 0.f;
  const int gida = active ? gid[sa] : -1;
  const int ewa = active ? ew[sa] : 0;
  const float two_over_sqrt_pi = 1.1283791670955126f;

  for (int i = threadIdx.x; i < nf * fstride; i += blockDim.x) fr[i] = 0.f;
  if (wpart == 0 && lane == 0) shome[h] = na;

  float fx = 0.f, fy = 0.f, fz = 0.f;
  for (int o = 0; o < n_off; ++o) {
    const int ox = offsets[3 * o], oy = offsets[3 * o + 1],
              oz = offsets[3 * o + 2];
    const float tx = shift[3 * o], ty = shift[3 * o + 1],
                tz = shift[3 * o + 2];
    const bool self = (o == 0);
    const bool chk = check_excl[o] != 0 && excl_window > 0;
    __syncthreads();
    // stage the occupied slots of every home cell's neighbour at o
    for (int i = threadIdx.x; i < nh * cap; i += blockDim.x) {
      const int hh = i / cap, s = i - hh * cap;
      const int ux = x0 + hh / (p.by * p.bz), uy = y0 + (hh / p.bz) % p.by,
                uz = z0 + hh % p.bz;
      int nbn = 0, bc = 0;
      if (ux < p.gx && uy < p.gy && uz < p.gz) {
        bc = (wrap(ux + ox, p.gx) * p.gy + wrap(uy + oy, p.gy)) * p.gz +
             wrap(uz + oz, p.gz);
        nbn = count[bc];
      }
      if (s == 0) snb[hh] = nbn;
      if (s < nbn) {
        const int sb = bc * cap + s;
        sx[i] = x[sb] + tx;
        sy[i] = y[sb] + ty;
        sz[i] = z[sb] + tz;
        sq[i] = q[sb];
        ssig[i] = sig[sb];
        sseps[i] = seps[sb];
        sgid[i] = gid[sb];
      }
    }
    __syncthreads();
    if (live) {
      const int nb = snb[h];
      const int j0 = h * cap;
      float* ph = part + (wpart * nh + h) * fstride;
      for (int b = 0; b < nb; ++b) {
        const int j = j0 + b;
        const float dx = xa - sx[j];
        const float dy = ya - sy[j];
        const float dz = za - sz[j];
        // unfused, in the plain version's order: the cutoff test then
        // decides every pair exactly as the plain version does
        const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                             __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        bool keep = active && r2 < cutoff2 && !(self && b == a);
        if (chk) {
          const int dg = sgid[j] - gida;
          if (dg <= excl_window && dg >= -excl_window &&
              ((ewa >> (dg + excl_window)) & 1))
            keep = false;
        }
        float g2 = 0.f;
        if (keep) {
          const float r2s = fmaxf(r2, 1e-6f);
          const float inv_r = rsqrtf(r2s);
          const float inv_r2 = inv_r * inv_r;
          const float qq = qa * sq[j];
          const float sg = 0.5f * (siga + ssig[j]);
          const float ep = sepsa * sseps[j];
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
            ph[b] = -sxr;
            ph[cap + b] = -syr;
            ph[2 * cap + b] = -szr;
          }
        }
      }
    }
    if (!self) {
      __syncthreads();
      // one writer per frame entry: home cell hh's neighbour at o is frame
      // cell hh + o - lo, distinct for distinct hh
      for (int i = threadIdx.x; i < nh * fstride; i += blockDim.x) {
        const int hh = i / fstride, r = i - hh * fstride;
        const int nah = shome[hh];
        if (nah == 0 || r % cap >= snb[hh]) continue;
        float v = part[hh * fstride + r];
        for (int k = 1; k * 32 < nah; ++k) v += part[(k * nh + hh) * fstride + r];
        const int lx = hh / (p.by * p.bz) + ox - p.lox;
        const int ly = (hh / p.bz) % p.by + oy - p.loy;
        const int lz = hh % p.bz + oz - p.loz;
        fr[((lx * p.fy + ly) * p.fz + lz) * fstride + r] += v;
      }
    }
  }
  __syncthreads();
  if (active) {
    const int f0 = (((hx - p.lox) * p.fy + (hy - p.loy)) * p.fz +
                    (hz - p.loz)) * fstride;
    fr[f0 + a] += fx;
    fr[f0 + cap + a] += fy;
    fr[f0 + 2 * cap + a] += fz;
  }
  __syncthreads();
  float* out = frames + chunk * nf * fstride;
  for (int i = threadIdx.x; i < nf * fstride; i += blockDim.x) out[i] = fr[i];
}

// Each slot's force: the frame entries covering its cell, summed in the
// order of the tables (x outer, z inner; each table row lists (chunk,
// frame-local index) pairs, ended by -1 where shorter than its width).
__global__ void overlap_add_kernel(const float* __restrict__ frames,
                                   const int* __restrict__ tab_x,
                                   const int* __restrict__ tab_y,
                                   const int* __restrict__ tab_z, int lx,
                                   int ly, int lz, Plan p, int cap,
                                   float* __restrict__ f) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= p.gx * p.gy * p.gz * cap) return;
  const int cell = s / cap, a = s - cell * cap;
  const int cx = cell / (p.gy * p.gz), cy = (cell / p.gz) % p.gy,
            cz = cell % p.gz;
  const int nf = p.fx * p.fy * p.fz;
  const int* tx = tab_x + 2 * cx * lx;
  const int* ty = tab_y + 2 * cy * ly;
  const int* tz = tab_z + 2 * cz * lz;
  float fx = 0.f, fy = 0.f, fz = 0.f;
  for (int i = 0; i < lx && tx[2 * i] >= 0; ++i) {
    for (int j = 0; j < ly && ty[2 * j] >= 0; ++j) {
      for (int k = 0; k < lz && tz[2 * k] >= 0; ++k) {
        const int chunk = (tx[2 * i] * p.nby + ty[2 * j]) * p.nbz + tz[2 * k];
        const int fcell = (tx[2 * i + 1] * p.fy + ty[2 * j + 1]) * p.fz +
                          tz[2 * k + 1];
        const float* fr = frames + (chunk * nf + fcell) * 3 * cap + a;
        fx += fr[0];
        fy += fr[cap];
        fz += fr[2 * cap];
      }
    }
  }
  f[3 * s] = fx;
  f[3 * s + 1] = fy;
  f[3 * s + 2] = fz;
}

Plan make_plan(const int* v) {
  Plan p;
  p.gx = v[0]; p.gy = v[1]; p.gz = v[2];
  p.bx = v[3]; p.by = v[4]; p.bz = v[5];
  p.nbx = v[6]; p.nby = v[7]; p.nbz = v[8];
  p.lox = v[9]; p.loy = v[10]; p.loz = v[11];
  p.fx = v[12]; p.fy = v[13]; p.fz = v[14];
  return p;
}

}  // namespace

extern "C" int chunk_sweep_max_capacity() { return kMaxCap; }

// Dynamic shared memory of one CTA, in bytes.
extern "C" int chunk_sweep_smem_bytes(const int* plan, int cap) {
  const Plan p = make_plan(plan);
  const int nh = p.bx * p.by * p.bz, nf = p.fx * p.fy * p.fz;
  const int parts = (cap + 31) / 32;
  return 4 * (nf * 3 * cap + parts * nh * 3 * cap + 7 * nh * cap + 2 * nh);
}

// plan: the 15 ints of Plan, on the host.  frames: n_chunks * nf * 3 * cap
// floats of work space (every entry written by the sweep); f: (n_slots, 3).
extern "C" int chunk_sweep_forces(
    const void* x, const void* y, const void* z, const void* q,
    const void* sig, const void* seps, const void* gid, const void* ew,
    const void* count, const void* offsets, const void* shift,
    const void* check_excl, const void* tab_x, const void* tab_y,
    const void* tab_z, void* frames, void* f, const int* plan, int lx,
    int ly, int lz, int cap, int n_off, float cutoff2, float alpha,
    float coulomb_scale, int excl_window, void* stream) {
  const Plan p = make_plan(plan);
  const int nh = p.bx * p.by * p.bz;
  const int n_chunks = p.nbx * p.nby * p.nbz;
  const int threads = nh * ((cap + 31) / 32) * 32;
  if (cap < 1 || cap > kMaxCap || n_off < 1 || n_chunks < 1 ||
      threads > 1024)
    return (int)cudaErrorInvalidValue;
  const int smem = chunk_sweep_smem_bytes(plan, cap);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  chunk_sweep_kernel<<<n_chunks, threads, smem, s>>>(
      (const float*)x, (const float*)y, (const float*)z, (const float*)q,
      (const float*)sig, (const float*)seps, (const int*)gid, (const int*)ew,
      (const int*)count, (const int*)offsets, (const float*)shift,
      (const int*)check_excl, (float*)frames, p, cap, n_off, cutoff2, alpha,
      coulomb_scale, excl_window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_slots = p.gx * p.gy * p.gz * cap;
  overlap_add_kernel<<<(n_slots + 255) / 256, 256, 0, s>>>(
      (const float*)frames, (const int*)tab_x, (const int*)tab_y,
      (const int*)tab_z, lx, ly, lz, p, cap, (float*)f);
  return (int)cudaGetLastError();
}
