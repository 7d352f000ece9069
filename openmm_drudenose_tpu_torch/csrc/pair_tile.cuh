// The warp-tile pair loop shared by kernels B1 (sweep.cu) and B2
// (sweep_chunked.cu): one warp holds up to 32 home atoms of one cell, one
// a lane, in registers, and walks a tile of up to 32 slots of one
// neighbour cell, staged in shared memory private to the warp.
//
// The main walk is diagonal, as in OpenMM's CUDA nonbonded tiles: with
// m = max(home atoms, tile slots), at step k lane l pairs its home atom
// with tile slot (l + k) mod m.  Lanes l < m map to distinct slots at
// every step, so each slot's reaction has exactly one writer a step and
// accumulates with plain adds, in a fixed order (k = 0, 1, ...), with no
// cross-lane reduction and no atomics: lane l keeps the running reaction
// of the slot it pairs with in registers and hands it to lane l - 1
// (mod m) after each step (three shuffles a step); after m steps lane l
// holds slot l's.  (Adding the reactions into a warp-private shared
// array indexed by slot, behind a __syncwarp a step, was 4-20% slower on
// the H100; PERF.md.)
//
// The diagonal walk costs m steps for (home atoms x tile slots) pairs.
// Where one side is a small remainder (a cell's atoms past 32), tile_pair
// takes the broadcast walk over it instead: min steps, in which each
// lane stores its partial sums in a column of its own, summed per atom
// after the walk (no exchange between lanes inside the loop either).
//
// The pair rules are the plain version's (forces/cellpair.py::pair_tiles):
// r^2 unfused in its order (so the cutoff test decides every pair alike),
// clamp 1e-6, the self cell with b != a and row forces only, and the
// exclusion test (bit (dg + W) % 31 of word (dg + W) / 31 of the home
// atom's mask, any number of words) only at offsets flagged for it.
//
// The energy instantiation (kEnergy) walks the same tiles by the
// broadcast walk, with no forces and no reactions: each lane adds its
// home atom's pair energies, with CUDA's erfcf as the port's energy path
// (forces/cellpair.py::sweep with the exact erfc), into a double in the
// walk's fixed order; the self cell counts each pair from both sides at
// half weight.  warp_sum and sum_fixed_order finish the sum in an order
// fixed by the data, so two launches give the same bits.  The
// force-only instantiation compiles as it did without this flag.
//
// The Coulomb kind is a template parameter (kCoul) of the pair function
// and of every walk above it, as in the TPU kernel's _make_pair_g
// (ops/pallas_sweep.py:111-135 in the JAX package): kEwald, the real
// space erfc(alpha r) / r (the A&S 7.1.26 rational in the force, erfcf
// in the energy), or kRF, the reaction field qq (1/r + krf r^2 - crf),
// whose dE/dr^2 is qq (-1/(2 r^3) + krf).  `if constexpr` keeps each
// kind's arithmetic out of the other's instantiation.

#pragma once

#include <cuda_runtime.h>

namespace pair_tile {

// exclusion words of the home atom kept in registers (an unrolled select
// reads them: a dynamically indexed register array would go to local
// memory); words beyond these are read from device memory
constexpr int kRegWords = 4;

struct Fields {  // cell-major slot arrays (forces/cellpair.py::sorted_fields)
  const float *x, *y, *z, *q, *sig, *seps;
  const int *gid;
  const int *ew;     // (n_slots, n_words) row-major
  const int *count;  // (n_cells,)
};

struct Params {
  float cutoff2, alpha, coulomb_scale;
  int excl_window, n_words;
  float krf, crf;  // the reaction field's constants (kRF only)
};

// the Coulomb kinds of the pair function (the launches' `coulomb`)
enum Coulomb : int { kEwald = 0, kRF = 1 };

struct Tile {  // up to 32 neighbour slots, staged by one warp
  float4 xyzq[32];  // shifted position, charge
  float2 ss[32];    // sigma, sqrt(epsilon)
  int gid[32];
};

// the most atoms a broadcast walk with reactions covers, and the partial
// sums it keeps: row (c, k), column l holds component c of lane l's pair
// with atom k (rows padded to 33, so that the lanes' passes over their
// rows hit distinct banks)
constexpr int kBcastMax = 8;

struct Partials {
  float v[3][kBcastMax][33];
};

struct Home {  // one lane's home atom
  float x, y, z, q, sig, seps;
  int gid, slot;
  bool active;
  int w[kRegWords];
  const int* ew;  // all its words
};

// lane's atom: slot `slot` counted from slot index `base`, shifted by t
// (zero for a home atom)
__device__ __forceinline__ Home load_home(const Fields& f, const Params& p,
                                          int base, int slot, bool active,
                                          float tx = 0.f, float ty = 0.f,
                                          float tz = 0.f) {
  Home h;
  const int s = base + slot;
  h.active = active;
  h.slot = slot;
  h.x = active ? f.x[s] + tx : 0.f;
  h.y = active ? f.y[s] + ty : 0.f;
  h.z = active ? f.z[s] + tz : 0.f;
  h.q = active ? p.coulomb_scale * f.q[s] : 0.f;
  h.sig = active ? f.sig[s] : 1.f;
  h.seps = active ? f.seps[s] : 0.f;
  h.gid = active ? f.gid[s] : -1;
  h.ew = f.ew + (size_t)s * p.n_words;
#pragma unroll
  for (int k = 0; k < kRegWords; ++k)
    h.w[k] = (active && k < p.n_words) ? h.ew[k] : 0;
  return h;
}

// word `wi` of the home atom's exclusion mask
__device__ __forceinline__ int home_word(const Home& h, int wi) {
  int w = h.w[0];
#pragma unroll
  for (int k = 1; k < kRegWords; ++k)
    if (wi == k) w = h.w[k];
  if (wi >= kRegWords) w = __ldg(h.ew + wi);
  return w;
}

struct Box {  // the bounding box of a staged tile's positions
  float lo[3], hi[3];
};

// a float's bits as an int that orders as the float does (no NaNs here)
__device__ __forceinline__ int ordered(float v) {
  const int i = __float_as_int(v);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float unordered(int i) {
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// stage slots base .. base + n - 1 (n <= 32), shifted by t, into the
// warp's tile; returns their bounding box (every lane gets it)
__device__ __forceinline__ Box stage(Tile& t, const Fields& f, int base,
                                     int n, float tx, float ty, float tz,
                                     int lane) {
  float v[3] = {0.f, 0.f, 0.f};
  if (lane < n) {
    const int s = base + lane;
    v[0] = f.x[s] + tx;
    v[1] = f.y[s] + ty;
    v[2] = f.z[s] + tz;
    t.xyzq[lane] = make_float4(v[0], v[1], v[2], f.q[s]);
    t.ss[lane] = make_float2(f.sig[s], f.seps[s]);
    t.gid[lane] = f.gid[s];
  }
  Box b;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int k = ordered(v[d]);
    b.lo[d] = unordered(
        __reduce_min_sync(0xffffffffu, lane < n ? k : 0x7fffffff));
    b.hi[d] = unordered(
        __reduce_max_sync(0xffffffffu, lane < n ? k : (int)0x80000000));
  }
  __syncwarp();
  return b;
}

// Whether every pair between two boxes lies at or beyond the cutoff.
// Each gap is formed as the pairs' differences are and never exceeds
// theirs (rounding is monotone), and gap^2 is summed in r^2's order, so
// a tile skipped here holds no pair that the cutoff test would keep.
__device__ __forceinline__ bool beyond(const Box& a, const Box& b,
                                       float cutoff2) {
  float g[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    g[d] = fmaxf(0.f, fmaxf(b.lo[d] - a.hi[d], a.lo[d] - b.hi[d]));
  const float g2 = __fadd_rn(__fadd_rn(__fmul_rn(g[0], g[0]),
                                       __fmul_rn(g[1], g[1])),
                             __fmul_rn(g[2], g[2]));
  return g2 >= cutoff2;
}

// The force on the lane's atom h from slot j of tile t, by the pair rules
// above, or zero where the pair is not kept (`valid` false: no such slot).
// With kEnergy, the pair's energy into *pe instead (zero where not kept)
// and no force.  kCoul: the Coulomb kind.
template <int kCoul, bool kSelf, bool kEnergy = false>
__device__ __forceinline__ void pair_force(const Home& h, const Tile& t,
                                           int j, bool valid, int j0,
                                           bool chk, const Params& p,
                                           float& px, float& py, float& pz,
                                           float* pe = nullptr) {
  const int W = p.excl_window;
  px = py = pz = 0.f;
  if constexpr (kEnergy) *pe = 0.f;
  if (!(valid && h.active)) return;
  const float4 b = t.xyzq[j];
  const float dx = h.x - b.x;
  const float dy = h.y - b.y;
  const float dz = h.z - b.z;
  const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  bool keep = r2 < p.cutoff2 && !(kSelf && j0 + j == h.slot);
  if (keep && chk) {
    const int bit = t.gid[j] - h.gid + W;
    if ((unsigned)bit <= (unsigned)(2 * W)) {
      const int wi = bit / 31;
      if ((home_word(h, wi) >> (bit - 31 * wi)) & 1) keep = false;
    }
  }
  if (!keep) return;
  const float2 ss = t.ss[j];
  const float r2s = fmaxf(r2, 1e-6f);
  const float inv_r = rsqrtf(r2s);
  const float inv_r2 = inv_r * inv_r;
  const float qq = h.q * b.w;
  const float sg = 0.5f * (h.sig + ss.x);
  const float ep = h.seps * ss.y;
  const float s2 = sg * sg * inv_r2;
  const float x6 = s2 * s2 * s2;
  if constexpr (kEnergy) {
    float e_c;
    if constexpr (kCoul == kEwald)
      e_c = qq * erfcf(p.alpha * r2s * inv_r) * inv_r;
    else
      e_c = qq * (inv_r + p.krf * r2s - p.crf);
    *pe = 4.f * ep * x6 * (x6 - 1.f) + e_c;
    return;
  }
  const float g_lj = -4.f * ep * (6.f * x6 * x6 - 3.f * x6) * inv_r2;
  float g_c;
  if constexpr (kCoul == kEwald) {
    const float two_over_sqrt_pi = 1.1283791670955126f;
    const float ar = p.alpha * r2s * inv_r;
    const float tt = __fdividef(1.f, 1.f + 0.3275911f * ar);
    const float expm = __expf(-ar * ar);
    const float erfc_ar =
        tt * (0.254829592f +
              tt * (-0.284496736f +
                    tt * (1.421413741f +
                          tt * (-1.453152027f + tt * 1.061405429f)))) *
        expm;
    g_c = -0.5f * qq * inv_r2 *
          (erfc_ar * inv_r + two_over_sqrt_pi * p.alpha * expm);
  } else {
    g_c = qq * (-0.5f * inv_r2 * inv_r + p.krf);
  }
  const float g2 = -2.f * (g_lj + g_c);
  px = g2 * dx;
  py = g2 * dy;
  pz = g2 * dz;
}

// The diagonal walk: the home atoms (na of them, lanes 0..na-1) against
// the staged tile (nb slots, tile slot j being cell slot j0 + j).  Adds
// the row forces to (fx, fy, fz) and leaves in (rx, ry, rz) of lane l the
// sum of the reactions on tile slot l (zero for l >= nb).
template <int kCoul>
__device__ __forceinline__ void walk(const Home& h, const Tile& t, int na,
                                     int nb, int j0, bool chk,
                                     const Params& p, int lane, float& fx,
                                     float& fy, float& fz, float& rx,
                                     float& ry, float& rz) {
  const int m = max(na, nb);
  const int next = (lane + 1 == m) ? 0 : lane + 1;
  rx = ry = rz = 0.f;
  int j = lane;
  for (int k = 0; k < m; ++k) {
    float px, py, pz;
    pair_force<kCoul, false>(h, t, j, j < nb, j0, chk, p, px, py, pz);
    fx += px;
    fy += py;
    fz += pz;
    rx = __shfl_sync(0xffffffffu, rx - px, next);
    ry = __shfl_sync(0xffffffffu, ry - py, next);
    rz = __shfl_sync(0xffffffffu, rz - pz, next);
    j = (j + 1 == m) ? 0 : j + 1;
  }
}

// The broadcast walk: every lane's atom h against tile slot k at step k
// (nb steps).  Adds the lanes' forces to (fx, fy, fz).  With kReact
// (nb <= kBcastMax), lane l stores its pair's reaction on slot k in its
// own column of `part` at each step, with no exchange between lanes;
// after the walk lane c * kBcastMax + k sums row (c, k) in column order,
// and lane k takes its three sums into (rx, ry, rz).  With kEnergy
// (and no kReact), only the lane's pair energies, added to *esum in step
// order (at half weight in the self cell, which meets each pair twice).
template <int kCoul, bool kSelf, bool kReact, bool kEnergy = false>
__device__ __forceinline__ void walk_bcast(const Home& h, const Tile& t,
                                           int nb, int j0, bool chk,
                                           const Params& p, int lane,
                                           float& fx, float& fy, float& fz,
                                           float& rx, float& ry, float& rz,
                                           Partials& part,
                                           double* esum = nullptr) {
  static_assert(!(kEnergy && kReact), "the energy walk has no reactions");
  for (int k = 0; k < nb; ++k) {
    float px, py, pz;
    if constexpr (kEnergy) {
      float e;
      pair_force<kCoul, kSelf, true>(h, t, k, true, j0, chk, p, px, py, pz,
                                     &e);
      *esum += kSelf ? 0.5 * (double)e : (double)e;
      continue;
    }
    pair_force<kCoul, kSelf>(h, t, k, true, j0, chk, p, px, py, pz);
    fx += px;
    fy += py;
    fz += pz;
    if (kReact) {
      part.v[0][k][lane] = -px;
      part.v[1][k][lane] = -py;
      part.v[2][k][lane] = -pz;
    }
  }
  rx = ry = rz = 0.f;
  if (kReact) {
    __syncwarp();
    float sum = 0.f;
    if (lane < 3 * kBcastMax && lane % kBcastMax < nb) {
      const float* row = &part.v[0][0][0] + lane * 33;
      for (int i = 0; i < 32; ++i) sum += row[i];
    }
    const int k = lane % kBcastMax;
    rx = __shfl_sync(0xffffffffu, sum, k);
    ry = __shfl_sync(0xffffffffu, sum, kBcastMax + k);
    rz = __shfl_sync(0xffffffffu, sum, 2 * kBcastMax + k);
    if (lane >= nb) rx = ry = rz = 0.f;
    __syncwarp();  // the rows are written again by the next walk
  }
}

// One home part (na atoms from cell slot `abase` + a0, staged in `th`)
// against one staged neighbour tile t (nb slots from cell slot `nbase`,
// tile slot j being neighbour cell slot j0 + j), by the cheaper walk.
// The diagonal walk costs max(na, nb) steps.  Where one side is a
// remainder of at most kBcastMax atoms (a cell's atoms past 32) and the
// other at least 4 more, the broadcast walk over the smaller side costs
// min steps, a few stores each, and one pass over its partial sums.
// Over the tile's slots the lanes keep the home atoms; over the home
// atoms the lanes take the tile's atoms (shifted) and broadcast the
// staged home part: pair rules, masks (built symmetric) and r^2 are the
// same either way round.  The self offset has no reactions and takes the
// broadcast walk over the tile (nb <= max(na, nb) steps).  The lanes'
// atoms are loaded here, not held across calls, which keeps one atom's
// registers live at a time.  Adds the row forces to (fx, fy, fz) and
// leaves the reaction on tile slot l in (rx, ry, rz) of lane l.
template <int kCoul>
__device__ __forceinline__ void tile_pair(
    bool self, const Fields& fd, const Params& p, int abase, int a0, int na,
    const Tile& th, const Tile& t, int nbase, int nb, int j0, float tx,
    float ty, float tz, bool chk, int lane, Partials& part, float& fx,
    float& fy, float& fz, float& rx, float& ry, float& rz) {
  const int lo = min(na, nb);
  const bool bcast = !self && lo <= kBcastMax && max(na, nb) >= lo + 4;
  if (bcast && nb > na) {
    const Home hb = load_home(fd, p, nbase, lane, lane < nb, tx, ty, tz);
    float gx = 0.f, gy = 0.f, gz = 0.f, sx, sy, sz;
    walk_bcast<kCoul, false, true>(hb, th, na, a0, chk, p, lane, gx, gy, gz,
                                   sx, sy, sz, part);
    fx += sx;
    fy += sy;
    fz += sz;
    rx = gx;
    ry = gy;
    rz = gz;
    return;
  }
  const Home h = load_home(fd, p, abase, a0 + lane, lane < na);
  if (self) {
    walk_bcast<kCoul, true, false>(h, t, nb, j0, chk, p, lane, fx, fy, fz, rx,
                                   ry, rz, part);
  } else if (bcast) {
    walk_bcast<kCoul, false, true>(h, t, nb, j0, chk, p, lane, fx, fy, fz, rx,
                                   ry, rz, part);
  } else {
    walk<kCoul>(h, t, na, nb, j0, chk, p, lane, fx, fy, fz, rx, ry, rz);
  }
}

// The energy of one home part (na atoms from cell slot `abase` + a0)
// against one staged tile t (nb slots, tile slot j being cell slot
// j0 + j), added to the lane's *esum by the broadcast walk.
template <int kCoul>
__device__ __forceinline__ void tile_energy(bool self, const Fields& fd,
                                            const Params& p, int abase,
                                            int a0, int na, const Tile& t,
                                            int nb, int j0, bool chk,
                                            int lane, Partials& part,
                                            double& esum) {
  const Home h = load_home(fd, p, abase, a0 + lane, lane < na);
  float fx = 0.f, fy = 0.f, fz = 0.f, rx, ry, rz;
  if (self)
    walk_bcast<kCoul, true, false, true>(h, t, nb, j0, chk, p, lane, fx, fy,
                                         fz, rx, ry, rz, part, &esum);
  else
    walk_bcast<kCoul, false, false, true>(h, t, nb, j0, chk, p, lane, fx, fy,
                                          fz, rx, ry, rz, part, &esum);
}

// The sum of the warp's 32 values in a fixed tree order, on lane 0.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// *out = the sum of in[0 .. n-1] in an order fixed by n: one CTA of
// kSumThreads threads, each adding a strided share in index order, then
// a tree in shared memory.  Launched as <<<1, kSumThreads>>>.
constexpr int kSumThreads = 1024;

__global__ void __launch_bounds__(kSumThreads)
    sum_fixed_order(const double* __restrict__ in, int n,
                    double* __restrict__ out) {
  __shared__ double s[kSumThreads];
  double v = 0.0;
  for (int i = threadIdx.x; i < n; i += kSumThreads) v += in[i];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int w = kSumThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = s[0];
}

// out[r] = the sum of in[rows[r * m + i]], i = 0 .. m-1, for every row r
// of the (n_rows, m) index table, each in an order fixed by the table:
// one CTA of kSumThreads threads a row, as sum_fixed_order.  Launched as
// <<<n_rows, kSumThreads>>>; the per-replica energies of a flattened
// ensemble (each row lists the partials of one replica's cells).
__global__ void __launch_bounds__(kSumThreads)
    sum_rows_fixed_order(const double* __restrict__ in,
                         const int* __restrict__ rows, int m,
                         double* __restrict__ out) {
  __shared__ double s[kSumThreads];
  const int* row = rows + (size_t)blockIdx.x * m;
  double v = 0.0;
  for (int i = threadIdx.x; i < m; i += kSumThreads) v += in[row[i]];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int w = kSumThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = s[0];
}

}  // namespace pair_tile
