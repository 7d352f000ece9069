// Kernel B1: the direct-space cell-pair sweep; the Hopper counterpart of
// the TPU kernel ops/pallas_sweep.py::pair_forces_pallas in the JAX
// package (forces only), with an energy instantiation of its own.
//
// Physics: LJ with Lorentz sigma and Berthelot sqrt(eps) product, plus
// either Ewald real-space Coulomb with the Abramowitz & Stegun 7.1.26
// erfc (the same polynomial as the TPU kernel, so the two agree term for
// term) or the reaction field qq (1/r + krf r^2 - crf) (CutoffPeriodic);
// the LJ switched from r_on to the cutoff where the launch asks for it
// (an instantiation of its own, kSwitch: pair_tile.cuh; the TPU kernel
// has no switch).
// Pairs: the home cell against itself (a != b, row forces only) and the
// half stencil of neighbour cells, each pair's reaction credited to the
// neighbour slot (Newton's third law).  Cutoff test, r^2 clamp 1e-6, an
// exclusion bitmask of any number of 31-bit words over atom-index
// differences within W, tested only at offsets flagged in `check_excl`.
//
// What bounds it: the pair arithmetic (1.9e8 pair tests, 3.6e7 inside
// the cutoff, at the 100k-atom bench size: 15^3 cells, 63 offsets); the
// inputs are a few MB.  So the design spends the card's issue slots on
// pairs and little else:
//
//  * Work units of (home cell, 32-slot part, 8 stencil offsets), taken in
//    order from a counter by as many warps as the card holds at once:
//    the card stays busy to the end (one warp per (cell, part) left a
//    tail of a second partial wave) and empty parts cost nothing.  No CTA
//    barrier anywhere: each warp stages its tiles in shared memory of its
//    own and syncs with __syncwarp only.
//  * The pair loop is the warp-tile walk of pair_tile.cuh: each diagonal
//    step pairs every lane with a distinct neighbour slot, so reactions
//    sum with plain adds rotated through the lanes instead of a 5-level
//    shuffle reduction per neighbour slot; a remainder part or tile past
//    32 slots takes the broadcast walk over it, with partial sums in a
//    column of shared memory a lane.
//  * Every sum runs in an order fixed by the data, so two launches on the
//    same inputs give the same bits (the checkpoint replay of a run
//    routed here depends on it).  No atomics add forces: each (home cell,
//    part, stencil offset) writes its reactions on the neighbour's slots
//    into a frame entry of its own (rframe), one writer an entry, and
//    each work unit writes its home part's row forces into an entry of
//    its own (hframe).  A second kernel (gather_kernel) gives each slot
//    its force: its cell's home entries in group order, then the
//    reactions of every cell whose half stencil reaches it, in part and
//    offset order (the reverse neighbour map rnbr).  The frames cost
//    device-memory traffic (at 100k atoms, 15^3 cells, C = 48: ~1e8
//    bytes written and read again against the sweep's few MB of
//    fields), which the sweep's stores overlap with its pair arithmetic.
//
// Any cell capacity (tiles of 32 on both sides) and any number of
// exclusion words (kRegWords of them in registers, the rest read from
// device memory).  The Coulomb kind is a template parameter (Ewald real
// space or the reaction field, as the TPU kernel's method argument), so
// each kind compiles to its own instantiation.
//
// Per-replica box scales (flat-ensemble NPT, kScaled): replica r's box
// is the template box times s_r.  The fields hold physical cell-local
// coordinates (position minus s_r times the cell centre and image,
// forces/cellpair.py::sorted_fields), so the only change is the shift
// table: (n_replicas, n_off, 3), s_r times the template's, read at the
// home cell's replica (rep_cell, a small int table a cell).  r^2, the
// cutoff test, the culling boxes and the forces are then physical, and
// the pair function and its float32 rounding order are unchanged.  The
// JAX package runs this path on its XLA sweep in stored coordinates
// p / s_r (r^2 times s_r^2, forces times s_r); no TPU kernel takes it.
// kScaled is a template parameter: the unscaled instantiations compile
// to the code they were.  The scaled energy instantiation's partials are
// summed per replica (pair_tile::sum_rows_fixed_order).
//
// The energy instantiation (sweep_energy) is the same unit loop with the
// energy walk of pair_tile.cuh: the exact erfc (erfcf) or the reaction
// field, no forces; each unit's energy, summed in double in a fixed
// order, goes to a partial of its own, and one CTA sums the partials in
// index order.  The JAX package computes this energy outside Pallas (its
// XLA sweep); here it is a kernel so that the barostat and
// getState(energy=True) read it without the plain sweep.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "pair_tile.cuh"

namespace {

using pair_tile::Fields;
using pair_tile::Params;
using pair_tile::Tile;

constexpr int kWarps = 4;           // warps a CTA
constexpr int kOffsetsPerUnit = 8;  // stencil offsets a work unit

// A work unit is (home cell, 32-slot part, group of kOffsetsPerUnit
// offsets); warps take units in order from the counter *next_unit until
// none is left, so the card stays busy to the end (a unit whose part is
// empty is skipped at once).  Units are numbered cell-major, so a
// home-slab range of cells [cell_lo, cell_hi) is the unit range
// [unit_lo, unit_hi): the launch takes only those (an x-slab of the grid
// on one rank, parallel/sharded.py); their reactions still land in any
// cell the half stencil reaches.  The counter starts at unit_lo
// (set_counter; a memset for the whole grid) and the loop ends at
// cell_hi's first unit, so the kernel is the whole-grid launch's to the
// instruction (that launch passes cell_lo = 0, cell_hi = n_cells): the
// range costs no register.
// The force instantiation writes the reactions of offset o >= 1 on
// neighbour slot b into
// rframe[entry(cell, part, o)][component][b] for every slot b of the
// neighbour (zeros where the tile lies beyond the cutoff), and the unit's
// row forces into hframe[(cell, part, group)][component][lane].  With
// kEnergy the unit's energy goes to e_part[unit] (left zero for an empty
// part) and no force is written.
// With kScaled the shifts are read at the home cell's replica,
// shift[3 * (rep_cell[cell] * n_off + o)].  kSwitch: the LJ switch.
template <bool kEnergy, int kCoul, bool kScaled, bool kSwitch>
__global__ void __launch_bounds__(kWarps * 32)
    sweep_kernel(Fields fd, const int* __restrict__ nbr,
                 const float* __restrict__ shift,
                 const int* __restrict__ rep_cell,
                 const int* __restrict__ check_excl,
                 float* __restrict__ rframe, float* __restrict__ hframe,
                 double* __restrict__ e_part, int* __restrict__ next_unit,
                 int cell_hi, int cap, int parts, int n_off, int n_groups,
                 Params p) {
  __shared__ Tile tiles[kWarps][2];
  __shared__ pair_tile::Partials partials[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int unit_hi = cell_hi * parts * n_groups;
  Tile& t = tiles[warp][0];   // the neighbour tile
  Tile& th = tiles[warp][1];  // the home part
  pair_tile::Partials& part = partials[warp];
  for (;;) {
    int unit = 0;
    if (lane == 0) unit = atomicAdd(next_unit, 1);
    unit = __shfl_sync(0xffffffffu, unit, 0);
    if (unit >= unit_hi) break;
    const int cp = unit / n_groups;
    const int o0 = (unit - cp * n_groups) * kOffsetsPerUnit;
    const int cell = cp / parts;
    const int a0 = (cp - cell * parts) * 32;
    const int na = min(fd.count[cell] - a0, 32);  // home atoms of the part
    if (na <= 0) continue;                        // warp-uniform
    const pair_tile::Box home =
        pair_tile::stage(th, fd, cell * cap + a0, na, 0.f, 0.f, 0.f, lane);
    float fx = 0.f, fy = 0.f, fz = 0.f, rx, ry, rz;
    double es = 0.0;
    const float* sh = shift;
    if constexpr (kScaled) sh = shift + (size_t)3 * rep_cell[cell] * n_off;
    for (int o = o0; o < min(o0 + kOffsetsPerUnit, n_off); ++o) {
      const int bc = nbr[cell * n_off + o];
      const int nb = fd.count[bc];
      const float tx = sh[3 * o], ty = sh[3 * o + 1], tz = sh[3 * o + 2];
      const bool chk = check_excl[o] != 0 && p.excl_window > 0;
      // this (cell, part, o)'s frame entry: (3, cap) floats
      float* fo = (kEnergy || o == 0)
                      ? nullptr
                      : rframe + ((size_t)cp * (n_off - 1) + (o - 1)) * 3 *
                                     (size_t)cap;
      for (int b0 = 0; b0 < nb; b0 += 32) {
        const int nb_t = min(nb - b0, 32);
        const pair_tile::Box nbox =
            pair_tile::stage(t, fd, bc * cap + b0, nb_t, tx, ty, tz, lane);
        if (o != 0 && pair_tile::beyond(home, nbox, p.cutoff2)) {
          if (!kEnergy && lane < nb_t) {
            fo[b0 + lane] = 0.f;
            fo[cap + b0 + lane] = 0.f;
            fo[2 * cap + b0 + lane] = 0.f;
          }
          continue;
        }
        if constexpr (kEnergy) {
          pair_tile::tile_energy<kCoul, kSwitch>(o == 0, fd, p, cell * cap,
                                                 a0, na, t, nb_t, b0, chk,
                                                 lane, part, es);
        } else {
          pair_tile::tile_pair<kCoul, kSwitch>(
              o == 0, fd, p, cell * cap, a0, na, th, t, bc * cap + b0, nb_t,
              b0, tx, ty, tz, chk, lane, part, fx, fy, fz, rx, ry, rz);
          if (o != 0 && lane < nb_t) {
            fo[b0 + lane] = rx;
            fo[cap + b0 + lane] = ry;
            fo[2 * cap + b0 + lane] = rz;
          }
        }
        __syncwarp();  // the tile is restaged next
      }
    }
    if constexpr (kEnergy) {
      es = pair_tile::warp_sum(es);
      if (lane == 0) e_part[unit] = es;
    } else if (lane < na) {
      float* fh = hframe + (size_t)unit * 96;
      fh[lane] = fx;
      fh[32 + lane] = fy;
      fh[64 + lane] = fz;
    }
  }
}

// Each slot's force from the frames, in an order fixed by the data: its
// cell's home entries (one a group of offsets) in group order, then the
// reactions written by the cells rnbr[cell, o] (whose offset-o neighbour
// is this cell), part by part and, within a part, in offset order.
// Entries of an empty home part were never written and are not read,
// nor are those of a home cell outside the launch's range [cell_lo,
// cell_hi) (kRange; the whole grid's launch runs the instantiation
// without the range tests).  Slots past the cell's
// count get zero.  Each reaction costs a chain of
// three dependent loads (rnbr, count, the entry); the offset loop is
// unrolled so that the chains of several offsets are in flight at once
// (one at a time, the gather took 0.11 ms at 100k atoms on an NVIDIA H100
// 80GB HBM3 at 700 W).
// The work-unit counter's start: the first unit of the launch's range.
__global__ void set_counter(int* __restrict__ next_unit, int unit_lo) {
  *next_unit = unit_lo;
}

template <bool kRange>
__global__ void gather_kernel(const float* __restrict__ rframe,
                              const float* __restrict__ hframe,
                              const int* __restrict__ count,
                              const int* __restrict__ rnbr, int n_cells,
                              int cell_lo, int cell_hi, int cap, int parts,
                              int n_off, int n_groups,
                              float* __restrict__ f) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= (long long)n_cells * cap) return;
  const int cell = (int)(s / cap), a = (int)(s - (long long)cell * cap);
  float fx = 0.f, fy = 0.f, fz = 0.f;
  if (a < count[cell]) {
    if (!kRange || (cell >= cell_lo && cell < cell_hi)) {
      const float* fh = hframe +
                        ((size_t)(cell * parts + (a >> 5)) * n_groups) * 96 +
                        (a & 31);
      for (int g = 0; g < n_groups; ++g) {
        fx += fh[96 * g];
        fy += fh[96 * g + 32];
        fz += fh[96 * g + 64];
      }
    }
    const int* rn = rnbr + (size_t)cell * n_off;
    const size_t entry = 3 * (size_t)cap;
    for (int pt = 0; pt < parts; ++pt) {
#pragma unroll 8
      for (int o = 1; o < n_off; ++o) {
        const int hc = rn[o];
        if ((!kRange || (hc >= cell_lo && hc < cell_hi)) &&
            count[hc] > 32 * pt) {
          const float* fr =
              rframe +
              ((size_t)(hc * parts + pt) * (n_off - 1) + (o - 1)) * entry +
              a;
          fx += fr[0];
          fy += fr[cap];
          fz += fr[2 * cap];
        }
      }
    }
  }
  f[3 * s] = fx;
  f[3 * s + 1] = fy;
  f[3 * s + 2] = fz;
}

// The launch shared by every instantiation: rframe, hframe, rnbr and f
// (forces) or e_part and e_out (energy) are the outputs' and their work
// space; the others may be null.  kScaled: rep_cell gives each cell's
// replica, and the energy goes to e_out[0 .. n_rows - 1], row r the sum
// of the partials listed in rows[r * m .. r * m + m - 1].
template <bool kEnergy, int kCoul, bool kScaled, bool kSwitch>
int launch(const Fields& fd, const void* nbr, const void* rnbr,
           const void* shift, const void* rep_cell, const void* check_excl,
           void* rframe, void* hframe, void* f, void* e_part, void* e_out,
           void* next_unit, const void* rows, int n_rows, int m,
           int n_cells, int cell_lo, int cell_hi, int cap, int n_off,
           const Params& p, int max_ctas, void* stream) {
  const long long parts = (cap + 31) / 32;
  const long long n_groups = (n_off + kOffsetsPerUnit - 1) / kOffsetsPerUnit;
  const long long units = (long long)n_cells * parts * n_groups;
  const long long unit_lo = (long long)cell_lo * parts * n_groups;
  const long long unit_hi = (long long)cell_hi * parts * n_groups;
  if (cap < 1 || n_cells < 1 || n_off < 1 || p.n_words < 1 ||
      cell_lo < 0 || cell_lo > cell_hi || cell_hi > n_cells ||
      max_ctas < 1 || 3LL * n_cells * cap > INT32_MAX ||
      (long long)n_cells * cap * p.n_words > INT32_MAX ||
      (long long)n_cells * n_off > INT32_MAX || units > INT32_MAX ||
      (kScaled && kEnergy && (n_rows < 1 || m < 1 || rows == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bool whole = cell_lo == 0 && cell_hi == n_cells;
  cudaError_t err;
  if (whole) {
    err = cudaMemsetAsync(next_unit, 0, sizeof(int), s);
  } else {
    set_counter<<<1, 1, 0, s>>>((int*)next_unit, (int)unit_lo);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess && kEnergy)
    err = cudaMemsetAsync(e_part, 0, units * sizeof(double), s);
  if (err != cudaSuccess) return (int)err;
  // as many CTAs as the card holds at once (they loop over the units);
  // an empty range launches no sweep
  const int blocks = (int)std::min<long long>(
      (unit_hi - unit_lo + kWarps - 1) / kWarps, (long long)max_ctas);
  if (blocks > 0) {
    sweep_kernel<kEnergy, kCoul, kScaled, kSwitch>
        <<<blocks, kWarps * 32, 0, s>>>(
        fd, (const int*)nbr, (const float*)shift, (const int*)rep_cell,
        (const int*)check_excl, (float*)rframe, (float*)hframe,
        (double*)e_part, (int*)next_unit, cell_hi, cap, (int)parts, n_off,
        (int)n_groups, p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if constexpr (kEnergy && kScaled) {
    pair_tile::sum_rows_fixed_order<<<n_rows, pair_tile::kSumThreads, 0,
                                      s>>>((const double*)e_part,
                                           (const int*)rows, m,
                                           (double*)e_out);
  } else if constexpr (kEnergy) {
    pair_tile::sum_fixed_order<<<1, pair_tile::kSumThreads, 0, s>>>(
        (const double*)e_part, (int)units, (double*)e_out);
  } else {
    const long long n_slots = (long long)n_cells * cap;
    const int gblocks = (int)((n_slots + 255) / 256);
    if (whole)
      gather_kernel<false><<<gblocks, 256, 0, s>>>(
          (const float*)rframe, (const float*)hframe, fd.count,
          (const int*)rnbr, n_cells, cell_lo, cell_hi, cap, (int)parts,
          n_off, (int)n_groups, (float*)f);
    else
      gather_kernel<true><<<gblocks, 256, 0, s>>>(
          (const float*)rframe, (const float*)hframe, fd.count,
          (const int*)rnbr, n_cells, cell_lo, cell_hi, cap, (int)parts,
          n_off, (int)n_groups, (float*)f);
  }
  return (int)cudaGetLastError();
}

// The instantiation of the Coulomb kind `coulomb` (pair_tile::Coulomb),
// scaled where rep_cell is given, switched where `switched`.
template <bool kEnergy>
int launch_kind(int coulomb, bool switched, const Fields& fd,
                const void* nbr, const void* rnbr, const void* shift,
                const void* rep_cell, const void* check_excl, void* rframe,
                void* hframe, void* f, void* e_part, void* e_out,
                void* next_unit, const void* rows, int n_rows, int m,
                int n_cells, int cell_lo, int cell_hi, int cap, int n_off,
                const Params& p, int max_ctas, void* stream) {
#define SWEEP_LAUNCH(COUL, SCALED, SW)                                      \
  launch<kEnergy, COUL, SCALED, SW>(fd, nbr, rnbr, shift, rep_cell,        \
                                    check_excl, rframe, hframe, f, e_part, \
                                    e_out, next_unit, rows, n_rows, m,     \
                                    n_cells, cell_lo, cell_hi, cap, n_off, \
                                    p, max_ctas, stream)
#define SWEEP_LAUNCH_SW(COUL, SCALED)                                     \
  (switched ? SWEEP_LAUNCH(COUL, SCALED, true)                            \
            : SWEEP_LAUNCH(COUL, SCALED, false))
  const bool scaled = rep_cell != nullptr;
  if (coulomb == pair_tile::kEwald)
    return scaled ? SWEEP_LAUNCH_SW(pair_tile::kEwald, true)
                  : SWEEP_LAUNCH_SW(pair_tile::kEwald, false);
  if (coulomb == pair_tile::kRF)
    return scaled ? SWEEP_LAUNCH_SW(pair_tile::kRF, true)
                  : SWEEP_LAUNCH_SW(pair_tile::kRF, false);
#undef SWEEP_LAUNCH_SW
#undef SWEEP_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// The kernel function of (energy, coulomb) with kScaled and kSwitch, or
// null.
template <bool kScaled, bool kSwitch>
const void* kernel_of_kind(int energy, int coulomb) {
  if (coulomb == pair_tile::kEwald)
    return energy ? (const void*)
                        sweep_kernel<true, pair_tile::kEwald, kScaled, kSwitch>
                  : (const void*)sweep_kernel<false, pair_tile::kEwald,
                                              kScaled, kSwitch>;
  if (coulomb == pair_tile::kRF)
    return energy
               ? (const void*)
                     sweep_kernel<true, pair_tile::kRF, kScaled, kSwitch>
               : (const void*)
                     sweep_kernel<false, pair_tile::kRF, kScaled, kSwitch>;
  return nullptr;
}

const void* kernel_of(int energy, int coulomb, int scaled, int switched) {
  if (scaled)
    return switched ? kernel_of_kind<true, true>(energy, coulomb)
                    : kernel_of_kind<true, false>(energy, coulomb);
  return switched ? kernel_of_kind<false, true>(energy, coulomb)
                  : kernel_of_kind<false, false>(energy, coulomb);
}

}  // namespace

// Warps a CTA.
extern "C" int sweep_warps_per_cta() { return kWarps; }

// Work units (energy partials, home-row frame entries) of a launch.
extern "C" int sweep_units(int n_cells, int cap, int n_off) {
  return n_cells * ((cap + 31) / 32) *
         ((n_off + kOffsetsPerUnit - 1) / kOffsetsPerUnit);
}

// out[0..3]: registers a thread, static shared memory, the most threads
// a CTA may have and local (spill) memory a thread, as compiled for the
// card, of the force (energy = 0) or the energy instantiation of the
// Coulomb kind `coulomb`, with per-replica scales where `scaled`, with
// the LJ switch where `switched`.
extern "C" int sweep_attributes(int* out, int energy, int coulomb,
                                int scaled, int switched) {
  const void* k = kernel_of(energy, coulomb, scaled, switched);
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

// out[0..1]: the current card's SMs and the CTAs an SM holds at once of
// the (energy, coulomb, scaled, switched) instantiation; the caller
// reads them once and passes SMs x CTAs to sweep_forces / sweep_energy
// as max_ctas.
extern "C" int sweep_occupancy(int* out, int energy, int coulomb,
                               int scaled, int switched) {
  const void* k = kernel_of(energy, coulomb, scaled, switched);
  if (k == nullptr) return (int)cudaErrorInvalidValue;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount,
                                 dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], k,
                                                        kWarps * 32, 0);
  return (int)err;
}

// f: (n_slots, 3), every entry written; ew: (n_slots, n_words); rnbr:
// (n_cells, n_off), the cell whose offset-o neighbour is the row's cell;
// shift: (n_off, 3), or (n_replicas, n_off, 3) with rep_cell (n_cells,),
// each cell's replica (null: no per-replica scales); rframe: n_cells *
// parts * (n_off - 1) * 3 * cap floats and hframe: sweep_units() * 96
// floats of work space (written before they are read); next_unit: one
// int of work space on the card (set to the range's first unit here);
// coulomb: pair_tile::Coulomb (krf and crf read for the reaction field
// only);
// use_switch: the switched instantiation, the LJ switch from r_on over
// sw_width = r_off - r_on (both read only with it); max_ctas: the CTAs
// the card holds at once (sweep_occupancy of the same instantiation);
// [cell_lo, cell_hi): the home cells whose stencils are summed (0 and
// n_cells for the whole grid), every slot of f written all the same.
extern "C" int sweep_forces(const void* x, const void* y, const void* z,
                            const void* q, const void* sig, const void* seps,
                            const void* gid, const void* ew,
                            const void* count, const void* nbr,
                            const void* rnbr, const void* shift,
                            const void* rep_cell, const void* check_excl,
                            void* rframe, void* hframe, void* f,
                            void* next_unit, int n_cells, int cell_lo,
                            int cell_hi, int cap, int n_off, float cutoff2,
                            float alpha,
                            float coulomb_scale, int excl_window,
                            int n_words, int coulomb, float krf, float crf,
                            int use_switch, float r_on, float sw_width,
                            int max_ctas, void* stream) {
  Fields fd{(const float*)x,   (const float*)y,    (const float*)z,
            (const float*)q,   (const float*)sig,  (const float*)seps,
            (const int*)gid,   (const int*)ew,     (const int*)count};
  Params p{cutoff2, alpha, coulomb_scale, excl_window, n_words,
           krf,     crf,   r_on,          sw_width};
  return launch_kind<false>(coulomb, use_switch != 0, fd, nbr, rnbr, shift,
                            rep_cell, check_excl, rframe, hframe, f, nullptr,
                            nullptr, next_unit, nullptr, 0, 0, n_cells,
                            cell_lo, cell_hi, cap, n_off, p, max_ctas,
                            stream);
}

// The direct-space energy into e_out on the card: e_part: sweep_units()
// doubles of work space (zeroed here), one partial a work unit.  Without
// rep_cell one double, the partials summed by sum_fixed_order; with it
// (shift and rep_cell as sweep_forces) n_rows doubles, the per-replica
// energies, row r the partials listed in rows[r * m .. r * m + m - 1]
// (sum_rows_fixed_order).  Other arguments as sweep_forces.
extern "C" int sweep_energy(const void* x, const void* y, const void* z,
                            const void* q, const void* sig, const void* seps,
                            const void* gid, const void* ew,
                            const void* count, const void* nbr,
                            const void* shift, const void* rep_cell,
                            const void* check_excl, void* e_part,
                            void* e_out, void* next_unit, const void* rows,
                            int n_cells, int cell_lo, int cell_hi, int cap,
                            int n_off, float cutoff2,
                            float alpha, float coulomb_scale,
                            int excl_window, int n_words, int coulomb,
                            float krf, float crf, int use_switch,
                            float r_on, float sw_width, int max_ctas,
                            int n_rows, int m, void* stream) {
  Fields fd{(const float*)x,   (const float*)y,    (const float*)z,
            (const float*)q,   (const float*)sig,  (const float*)seps,
            (const int*)gid,   (const int*)ew,     (const int*)count};
  Params p{cutoff2, alpha, coulomb_scale, excl_window, n_words,
           krf,     crf,   r_on,          sw_width};
  return launch_kind<true>(coulomb, use_switch != 0, fd, nbr, nullptr,
                           shift, rep_cell, check_excl, nullptr, nullptr,
                           nullptr, e_part, e_out, next_unit, rows, n_rows, m,
                           n_cells, cell_lo, cell_hi, cap, n_off, p, max_ctas,
                           stream);
}
