// Kernel B2: the chunked direct-space cell-pair sweep with deterministic
// reactions; the Hopper counterpart of the TPU kernel
// ops/pallas_sweep.py::pair_forces_pallas_chunked in the JAX package
// (forces only), with an energy instantiation of its own
// (chunk_sweep_energy: one partial a home cell, summed in a fixed order;
// see pair_tile.cuh).
//
// It computes what kernel B1 (sweep.cu) computes, pair for pair, with the
// same warp-tile pair loop (pair_tile.cuh): LJ with Lorentz sigma and
// Berthelot sqrt(eps) product plus Ewald real-space Coulomb with the
// Abramowitz & Stegun 7.1.26 erfc or the reaction field (the Coulomb
// kind is a template parameter), the home cell against itself (row
// forces only) and the half stencil with Newton reactions, the cutoff
// test on an unfused r^2 in the plain version's order, r^2 clamp 1e-6,
// and an exclusion bitmask of any number of words tested only at offsets
// flagged in `check_excl`.
//
// What differs is where the reactions go.  The TPU kernel runs a
// (x-layer, y-chunk) program grid; each program writes its reactions into
// a frame block of its own and XLA overlap-adds the blocks afterwards, so
// no program scatters into another's output.  Here:
//
//  * A chunk is a brick of bx*by*bz home cells, one CTA, one warp per
//    home cell.  The warp walks its cell's parts of 32 slots against the
//    tiles of 32 slots of each stencil neighbour, staged in shared memory
//    of its own, in a fixed order (offset, part, tile), by the walks of
//    pair_tile.cuh (diagonal, or broadcast over a remainder past 32).
//  * The chunk's frame is the brick grown by the stencil's span: every
//    cell that a home cell or its half stencil touches.  It is the
//    chunk's private block of device memory (zeroed by the CTA; no chunk
//    writes another's block), so shared memory holds only the warps'
//    tiles and row buffers and an SM keeps several CTAs.  After each
//    tile the warp's lane l adds the reaction on tile slot l into frame
//    cell home + offset; home cells map to distinct frame cells at one
//    offset, so each frame entry has one writer, and one barrier per
//    offset keeps the offsets apart (cell h + o of one home is cell
//    h' + o' of another).  Row forces collect in a per-warp row buffer
//    in shared memory and go into the home's own frame cell at the end.
//    No atomics anywhere.
//  * overlap_add_kernel then gives each slot the sum of every frame entry
//    that covers its cell, in a fixed order (per-dimension tables of
//    (chunk, frame-local index) built by ops/sweep_chunked.py).
//
// Every sum runs in an order fixed by the data, so two launches on the
// same inputs give bit-identical forces (B1's global atomicAdd does not).
// What bounds it: the pair arithmetic, as B1 (1.5e9 pair tests at 800k
// atoms, 30^3 cells, 63 offsets); the frames add a few hundred MB of
// device-memory traffic at that size.  The
// warp-tile walk spends the issue slots on pairs (no per-slot shuffle
// reduction, no per-offset combine pass); the per-offset barrier waits
// for a CTA's slowest warp, so the wrapper takes a small brick, 1 x 2 x 2
// cells, several CTAs an SM (ops/sweep_chunked.py::BRICK).
// Any capacity whose row buffers fit a CTA's shared memory (4429 slots
// at that brick); ops/sweep.py::route raises past it.
//
// Replica bands (the TPU kernel's pz / px wrap, pallas_sweep.py:610-611):
// a grid of embedded replicas is cut into bands of one replica's period
// along each dimension, and the stencil wraps modulo the period inside
// the band (band * p + wrap(local + o, p)), so replicas never read each
// other's cells.  Each band has chunks of its own (ceil(period / brick),
// the last cut short: its home cells past the band edge idle), so no
// chunk straddles a band edge and each frame cell is one cell of one
// band.  Without bands the period is the grid and the chunks are the
// grid's.
//
// Per-replica box scales (flat-ensemble NPT, kScaled; see sweep.cu):
// the fields are physical and the shift table is (n_replicas, n_off, 3);
// a chunk lies in one band, so its replica, (band x) * (y bands) * (z
// bands) + ..., is known once per CTA and the chunk reads that
// replica's shifts.  The scaled energy instantiation's partials (one a
// home cell) are summed per replica (pair_tile::sum_rows_fixed_order).
// kScaled is a template parameter: the unscaled instantiations compile
// to the code they were.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "pair_tile.cuh"

namespace {

using pair_tile::Fields;
using pair_tile::Params;
using pair_tile::Tile;

struct Plan {
  int gx, gy, gz;     // cell grid
  int bx, by, bz;     // home cells per chunk in each dimension
  int nbx, nby, nbz;  // chunks per dimension (bands x chunks a band)
  int lox, loy, loz;  // lowest stencil offset per dimension
  int fx, fy, fz;     // frame cells per dimension: brick + stencil span
  int px, py, pz;     // one replica's cells per dimension (the wrap period)
  int kx, ky, kz;     // chunks per band per dimension
};

// v + o wrapped into [0, g), for |o| < g
__device__ __forceinline__ int wrap(int v, int g) {
  return v < 0 ? v + g : (v >= g ? v - g : v);
}

// at most kMaxWarps home cells a brick (one warp each): the launch bound.
// The compiler then holds the kernel to 64 registers with a spill of a
// few words; at 80 registers without a spill (a minimum of one CTA an SM
// in the bound) it ran 8% slower at 800k atoms, with 24 warps an SM in
// place of 32 (PERF.md)
constexpr int kMaxWarps = 8;

// With kEnergy: no frames and no barriers; each warp adds its home
// cell's pair energies (the energy walk of pair_tile.cuh) and writes
// their sum to e_part[chunk * home cells + h], zero for an empty cell.
// kCoul: the Coulomb kind (pair_tile::Coulomb).
// With kScaled, shift is (replicas, n_off, 3), read at the chunk's band.
template <bool kEnergy, int kCoul, bool kScaled>
__global__ void __launch_bounds__(kMaxWarps * 32)
    chunk_sweep_kernel(Fields fd, const int* __restrict__ offsets,
                       const float* __restrict__ shift,
                       const int* __restrict__ check_excl,
                       float* __restrict__ frames,
                       double* __restrict__ e_part, Plan pl, int cap,
                       int n_off, Params p) {
  extern __shared__ float4 smem4[];
  const int nh = pl.bx * pl.by * pl.bz;
  const int nf = pl.fx * pl.fy * pl.fz;
  const int fstride = 3 * cap;                   // floats per frame cell
  Tile* tiles = reinterpret_cast<Tile*>(smem4);  // (nh, 2) staged tiles
  pair_tile::Partials* partials =
      reinterpret_cast<pair_tile::Partials*>(tiles + 2 * nh);  // (nh,)
  float* rowf = reinterpret_cast<float*>(partials + nh);   // (nh, 3, cap)

  const int chunk = blockIdx.x;
  float* fr = kEnergy ? nullptr : frames + (size_t)chunk * nf * fstride;
  const int chx = chunk / (pl.nby * pl.nbz), chy = (chunk / pl.nbz) % pl.nby,
            chz = chunk % pl.nbz;
  const int h = threadIdx.x >> 5;                // brick-local home cell
  const int lane = threadIdx.x & 31;
  const int hx = h / (pl.by * pl.bz), hy = (h / pl.bz) % pl.by,
            hz = h % pl.bz;
  // the home cell: its band's first cell and its index in the band
  const int bax = (chx / pl.kx) * pl.px, bay = (chy / pl.ky) * pl.py,
            baz = (chz / pl.kz) * pl.pz;
  const int lx = (chx % pl.kx) * pl.bx + hx, ly = (chy % pl.ky) * pl.by + hy,
            lz = (chz % pl.kz) * pl.bz + hz;
  const float* sh = shift;
  if constexpr (kScaled) {
    const int rep = ((chx / pl.kx) * (pl.gy / pl.py) + chy / pl.ky) *
                        (pl.gz / pl.pz) +
                    chz / pl.kz;
    sh = shift + (size_t)3 * rep * n_off;
  }
  const bool home_ok = lx < pl.px && ly < pl.py && lz < pl.pz;
  const int cell = ((bax + lx) * pl.gy + bay + ly) * pl.gz + baz + lz;
  const int na = home_ok ? fd.count[cell] : 0;   // warp-uniform
  Tile& t = tiles[2 * h];       // the neighbour tile
  Tile& th = tiles[2 * h + 1];  // the home part
  pair_tile::Partials& part = partials[h];
  float* rowh = rowf + h * fstride;

  if constexpr (!kEnergy) {
    for (int i = threadIdx.x; i < nf * fstride; i += blockDim.x) fr[i] = 0.f;
    for (int i = threadIdx.x; i < nh * fstride; i += blockDim.x)
      rowf[i] = 0.f;
    __syncthreads();
  }

  float rx, ry, rz;
  double es = 0.0;
  for (int o = 0; o < n_off; ++o) {
    if (na > 0) {
      const int ox = offsets[3 * o], oy = offsets[3 * o + 1],
                oz = offsets[3 * o + 2];
      const float tx = sh[3 * o], ty = sh[3 * o + 1], tz = sh[3 * o + 2];
      const bool chk = check_excl[o] != 0 && p.excl_window > 0;
      const int bc = ((bax + wrap(lx + ox, pl.px)) * pl.gy + bay +
                      wrap(ly + oy, pl.py)) * pl.gz + baz +
                     wrap(lz + oz, pl.pz);
      const int nb = fd.count[bc];
      // this home cell's neighbour at o in the frame
      float* fo = kEnergy ? nullptr
                          : fr + (((hx + ox - pl.lox) * pl.fy +
                                   (hy + oy - pl.loy)) * pl.fz +
                                  (hz + oz - pl.loz)) * fstride;
      for (int a0 = 0; a0 < na; a0 += 32) {
        const int na_t = min(na - a0, 32);
        const pair_tile::Box home = pair_tile::stage(
            th, fd, cell * cap + a0, na_t, 0.f, 0.f, 0.f, lane);
        float fx = 0.f, fy = 0.f, fz = 0.f;
        for (int b0 = 0; b0 < nb; b0 += 32) {
          const int nb_t = min(nb - b0, 32);
          const pair_tile::Box nbox =
              pair_tile::stage(t, fd, bc * cap + b0, nb_t, tx, ty, tz, lane);
          if (o != 0 && pair_tile::beyond(home, nbox, p.cutoff2)) continue;
          if constexpr (kEnergy) {
            pair_tile::tile_energy<kCoul>(o == 0, fd, p, cell * cap, a0,
                                          na_t, t, nb_t, b0, chk, lane, part,
                                          es);
          } else {
            pair_tile::tile_pair<kCoul>(o == 0, fd, p, cell * cap, a0, na_t,
                                        th, t, bc * cap + b0, nb_t, b0, tx,
                                        ty, tz, chk, lane, part, fx, fy, fz,
                                        rx, ry, rz);
            if (o != 0 && lane < nb_t) {
              float* e = fo + b0 + lane;
              if (rx != 0.f) e[0] += rx;
              if (ry != 0.f) e[cap] += ry;
              if (rz != 0.f) e[2 * cap] += rz;
            }
          }
          __syncwarp();  // the tiles are restaged next
        }
        if (!kEnergy && lane < na_t) {
          rowh[a0 + lane] += fx;
          rowh[cap + a0 + lane] += fy;
          rowh[2 * cap + a0 + lane] += fz;
        }
      }
    }
    // frame cell h + o of this home cell is h' + o' of another: the
    // barrier orders their writes
    if constexpr (!kEnergy) __syncthreads();
  }
  if constexpr (kEnergy) {
    es = pair_tile::warp_sum(es);
    if (lane == 0) e_part[chunk * nh + h] = es;
  } else if (na > 0) {
    float* own = fr + (((hx - pl.lox) * pl.fy + (hy - pl.loy)) * pl.fz +
                       (hz - pl.loz)) * fstride;
    for (int i = lane; i < fstride; i += 32) own[i] += rowh[i];
  }
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
  p.px = v[15]; p.py = v[16]; p.pz = v[17];
  p.kx = v[18]; p.ky = v[19]; p.kz = v[20];
  return p;
}

// The kernel function of (energy, coulomb, scaled), or null.
template <bool kScaled>
const void* kernel_of_scaled(int energy, int coulomb) {
  if (coulomb == pair_tile::kEwald)
    return energy ? (const void*)
                        chunk_sweep_kernel<true, pair_tile::kEwald, kScaled>
                  : (const void*)
                        chunk_sweep_kernel<false, pair_tile::kEwald, kScaled>;
  if (coulomb == pair_tile::kRF)
    return energy
               ? (const void*)chunk_sweep_kernel<true, pair_tile::kRF, kScaled>
               : (const void*)
                     chunk_sweep_kernel<false, pair_tile::kRF, kScaled>;
  return nullptr;
}

const void* kernel_of(int energy, int coulomb, int scaled) {
  return scaled ? kernel_of_scaled<true>(energy, coulomb)
                : kernel_of_scaled<false>(energy, coulomb);
}

}  // namespace

// out[0..3]: registers a thread, static shared memory, the most threads
// a CTA may have and local (spill) memory a thread, as compiled for the
// card, of the force (energy = 0) or the energy instantiation of the
// Coulomb kind `coulomb`, with per-replica scales where `scaled`.
extern "C" int chunk_sweep_attributes(int* out, int energy, int coulomb,
                                      int scaled) {
  const void* k = kernel_of(energy, coulomb, scaled);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, k);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

// out[0..5] of the current device: shared memory a CTA may opt in to,
// shared memory of an SM, shared memory reserved per CTA, registers of an
// SM, threads of an SM, SMs.
extern "C" int chunk_sweep_device(int* out) {
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  const cudaDeviceAttr attrs[6] = {
      cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrReservedSharedMemoryPerBlock,
      cudaDevAttrMaxRegistersPerMultiprocessor,
      cudaDevAttrMaxThreadsPerMultiProcessor,
      cudaDevAttrMultiProcessorCount};
  for (int i = 0; i < 6 && err == cudaSuccess; ++i)
    err = cudaDeviceGetAttribute(&out[i], attrs[i], dev);
  return (int)err;
}

// Dynamic shared memory of one CTA, in bytes: two staged tiles (the
// neighbour's and the home part), the broadcast walk's partial sums and a
// (3, cap) row-force buffer a warp.
extern "C" int chunk_sweep_smem_bytes(const int* plan, int cap) {
  const Plan p = make_plan(plan);
  const int nh = p.bx * p.by * p.bz;
  return nh * (2 * (int)sizeof(Tile) + (int)sizeof(pair_tile::Partials) +
               4 * 3 * cap);
}

// The checks and the sweep launch shared by every instantiation.
template <bool kEnergy, int kCoul, bool kScaled>
int launch_sweep(const Fields& fd, const void* offsets, const void* shift,
                 const void* check_excl, void* frames, void* e_part,
                 const int* plan, int cap, int n_off, const Params& p,
                 cudaStream_t s) {
  const Plan pl = make_plan(plan);
  const int nh = pl.bx * pl.by * pl.bz;
  const long long n_chunks = (long long)pl.nbx * pl.nby * pl.nbz;
  const long long n_slots = (long long)pl.gx * pl.gy * pl.gz * cap;
  const long long nf = (long long)pl.fx * pl.fy * pl.fz;
  if (cap < 1 || n_off < 1 || p.n_words < 1 || n_chunks < 1 ||
      pl.px < 1 || pl.py < 1 || pl.pz < 1 || pl.gx % pl.px ||
      pl.gy % pl.py || pl.gz % pl.pz ||
      pl.nbx != pl.gx / pl.px * pl.kx || pl.nby != pl.gy / pl.py * pl.ky ||
      pl.nbz != pl.gz / pl.pz * pl.kz ||
      nh > kMaxWarps || 3 * n_slots > INT32_MAX ||
      n_slots * p.n_words > INT32_MAX ||
      n_chunks * nf * 3 * cap > INT32_MAX ||
      n_chunks * nh > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  const int smem = chunk_sweep_smem_bytes(plan, cap);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_sweep_kernel<kEnergy, kCoul, kScaled>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  chunk_sweep_kernel<kEnergy, kCoul, kScaled>
      <<<(int)n_chunks, nh * 32, smem, s>>>(
          fd, (const int*)offsets, (const float*)shift,
          (const int*)check_excl, (float*)frames, (double*)e_part, pl, cap,
          n_off, p);
  return (int)cudaGetLastError();
}

// launch_sweep of the Coulomb kind `coulomb` (pair_tile::Coulomb), with
// per-replica scales where `scaled`.
template <bool kEnergy>
int launch_kind(int coulomb, int scaled, const Fields& fd,
                const void* offsets, const void* shift,
                const void* check_excl, void* frames, void* e_part,
                const int* plan, int cap, int n_off, const Params& p,
                cudaStream_t s) {
#define CHUNK_LAUNCH(COUL, SCALED)                                         \
  launch_sweep<kEnergy, COUL, SCALED>(fd, offsets, shift, check_excl,     \
                                      frames, e_part, plan, cap, n_off, p, \
                                      s)
  if (coulomb == pair_tile::kEwald)
    return scaled ? CHUNK_LAUNCH(pair_tile::kEwald, true)
                  : CHUNK_LAUNCH(pair_tile::kEwald, false);
  if (coulomb == pair_tile::kRF)
    return scaled ? CHUNK_LAUNCH(pair_tile::kRF, true)
                  : CHUNK_LAUNCH(pair_tile::kRF, false);
#undef CHUNK_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// plan: the 21 ints of Plan, on the host.  frames: n_chunks * nf * 3 * cap
// floats of work space (zeroed and filled by the sweep); f: (n_slots, 3);
// ew: (n_slots, n_words); scaled: shift is (replicas, n_off, 3), one
// table a replica band (per-replica box scales).
extern "C" int chunk_sweep_forces(
    const void* x, const void* y, const void* z, const void* q,
    const void* sig, const void* seps, const void* gid, const void* ew,
    const void* count, const void* offsets, const void* shift,
    const void* check_excl, const void* tab_x, const void* tab_y,
    const void* tab_z, void* frames, void* f, const int* plan, int lx,
    int ly, int lz, int cap, int n_off, float cutoff2, float alpha,
    float coulomb_scale, int excl_window, int n_words, int coulomb,
    float krf, float crf, int scaled, void* stream) {
  Fields fd{(const float*)x,   (const float*)y,    (const float*)z,
            (const float*)q,   (const float*)sig,  (const float*)seps,
            (const int*)gid,   (const int*)ew,     (const int*)count};
  Params p{cutoff2, alpha, coulomb_scale, excl_window, n_words, krf, crf};
  cudaStream_t s = (cudaStream_t)stream;
  int err = launch_kind<false>(coulomb, scaled, fd, offsets, shift,
                               check_excl, frames, nullptr, plan, cap, n_off,
                               p, s);
  if (err != 0) return err;
  const Plan pl = make_plan(plan);
  const long long n_slots = (long long)pl.gx * pl.gy * pl.gz * cap;
  overlap_add_kernel<<<(int)((n_slots + 255) / 256), 256, 0, s>>>(
      (const float*)frames, (const int*)tab_x, (const int*)tab_y,
      (const int*)tab_z, lx, ly, lz, pl, cap, (float*)f);
  return (int)cudaGetLastError();
}

// The direct-space energy into e_out on the card: e_part is n_chunks *
// home cells a chunk doubles of work space, one partial a home cell
// (every one written).  Unscaled: one double, the partials summed by
// sum_fixed_order.  Scaled (shift as chunk_sweep_forces): n_rows
// doubles, the per-replica energies, row r the partials listed in
// rows[r * m .. r * m + m - 1] (sum_rows_fixed_order).  Other arguments
// as chunk_sweep_forces.
extern "C" int chunk_sweep_energy(
    const void* x, const void* y, const void* z, const void* q,
    const void* sig, const void* seps, const void* gid, const void* ew,
    const void* count, const void* offsets, const void* shift,
    const void* check_excl, void* e_part, void* e_out, const void* rows,
    const int* plan, int cap, int n_off, float cutoff2, float alpha,
    float coulomb_scale, int excl_window, int n_words, int coulomb,
    float krf, float crf, int scaled, int n_rows, int m, void* stream) {
  Fields fd{(const float*)x,   (const float*)y,    (const float*)z,
            (const float*)q,   (const float*)sig,  (const float*)seps,
            (const int*)gid,   (const int*)ew,     (const int*)count};
  Params p{cutoff2, alpha, coulomb_scale, excl_window, n_words, krf, crf};
  cudaStream_t s = (cudaStream_t)stream;
  if (scaled && (n_rows < 1 || m < 1 || rows == nullptr))
    return (int)cudaErrorInvalidValue;
  int err = launch_kind<true>(coulomb, scaled, fd, offsets, shift,
                              check_excl, nullptr, e_part, plan, cap, n_off,
                              p, s);
  if (err != 0) return err;
  const Plan pl = make_plan(plan);
  if (scaled) {
    pair_tile::sum_rows_fixed_order<<<n_rows, pair_tile::kSumThreads, 0,
                                      s>>>((const double*)e_part,
                                           (const int*)rows, m,
                                           (double*)e_out);
  } else {
    const int n_part = pl.nbx * pl.nby * pl.nbz * pl.bx * pl.by * pl.bz;
    pair_tile::sum_fixed_order<<<1, pair_tile::kSumThreads, 0, s>>>(
        (const double*)e_part, n_part, (double*)e_out);
  }
  return (int)cudaGetLastError();
}
