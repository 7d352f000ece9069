// The Nose-Hoover chain of the TGNH integrator on the card: every bath's
// half-step chain update, and the NH pair of the fused step (the second
// half of one step and the first of the next on one KE measurement, the
// CM correction of the COM bath between them), in one launch.
//
// Replaces no TPU kernel: the JAX package runs the chain inside its
// jitted step as XLA code (integrators/tgnh.py::propagate_nh_chain, a
// lax.fori_loop over the drude_steps substeps, :211-294 there; the fused
// body _make_multi_step_fused, :809-941), never in Pallas.  The port ran
// it in numpy on the host, which read the per-bath KE (and the CM
// momentum) back from the card every step and copied the scales to the
// card again: two waits for the stream a step.  Here the chain state,
// the KE and the constants stay on the card, and the step reads nothing
// back.
//
// Arithmetic: the reference's propagateNHChain
// (CudaDrudeTGNHKernels.cpp:558-642): drude_steps symmetric Trotter
// substeps with exp(-dtc/8) damping and dtc/4 kicks over the M links;
// the Drude bath freezes links >= 1 unless Drude NH chains are on (the
// link mask).  Every operation in float64 registers, in the order of the
// plain version (ops/nh_chain.py::propagate_nh_chain), each product and
// sum rounded on its own (built with -fmad=false, as PyTorch's separate
// elementwise ops round): the two agree to the last bits or nearly.  The
// results are rounded to the state's type (T: float or double) where the
// plain version rounds them: after each half step (the scales, the
// chain, the damped KE), after the CM correction, and the composed scale
// and the CM shift at the end.
//
// What bounds it: launch latency.  One thread a (replica, bath) row of
// the (R, G+2) baths: an independent scalar recurrence of drude_steps x
// ~4M exponentials, a few hundred double operations, on a few hundred
// bytes of inputs.  There is no tile to share and no reduction across
// rows, so one thread a row is the whole design; the rows of a 70-replica
// ensemble (210) fill two CTAs of 128 threads.  Triton gains nothing on
// serial scalar work.
//
// Plain C interface for ctypes; the launch returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the most chain links a bath may have (local arrays a thread)
constexpr int kMaxChain = 16;
constexpr int kThreads = 128;

// mode bits: the first half, the second half, the CM correction (and,
// with the second half, the CM shift)
constexpr int kFirst = 1;
constexpr int kSecond = 2;
constexpr int kCm = 4;

struct Chain {
  double eta[kMaxChain];
  double ed[kMaxChain + 1];   // the last link's eta_dot stays 0
  double edd[kMaxChain];
};

template <typename T>
__device__ __forceinline__ double rnd(double x) {
  return (double)(T)x;
}

// One half step of a bath's chain (the plain version's loop, line for
// line); returns the velocity scale, *ke_io the damped KE.
template <typename T>
__device__ double half_step(Chain& c, double* ke_io, const T* eta_mass,
                            double nkbt, double kbt_chain,
                            const uint8_t* link, int M, int steps,
                            double dt) {
  const double dtc = dt / (double)steps;
  const double dtc2 = dtc / 2.0, dtc4 = dtc / 4.0, dtc8 = dtc / 8.0;
  const double m0 = (double)eta_mass[0];
  const bool mass0_pos = m0 > 0.0;
  const double inv_m0 = mass0_pos ? 1.0 / m0 : 0.0;
  double ke = *ke_io;
  if (mass0_pos) c.edd[0] = (ke - nkbt) * inv_m0;
  double vscale = 1.0;
  for (int s = 0; s < steps; ++s) {
    for (int i = M - 1; i >= 0; --i) {
      const double expfac = exp(-dtc8 * c.ed[i + 1]);
      const double nw = (c.ed[i] * expfac + c.edd[i] * dtc4) * expfac;
      if (link[i]) c.ed[i] = nw;
    }
    const double damp = exp(-dtc2 * c.ed[0]);
    vscale = vscale * damp;
    ke = ke * damp * damp;
    for (int i = 0; i < M; ++i)
      if (link[i]) c.eta[i] = c.eta[i] + dtc2 * c.ed[i];
    const double edd0 = mass0_pos ? (ke - nkbt) * inv_m0 : c.edd[0];
    c.edd[0] = edd0;
    const double expfac0 = exp(-dtc8 * c.ed[1]);
    c.ed[0] = (c.ed[0] * expfac0 + edd0 * dtc4) * expfac0;
    for (int i = 1; i < M; ++i) {
      const double expfac = exp(-dtc8 * c.ed[i + 1]);
      double d = c.ed[i] * expfac;
      const double mi = (double)eta_mass[i];
      const double inv_mi = mi > 0.0 ? 1.0 / mi : 0.0;
      const double eddi =
          ((double)eta_mass[i - 1] * (c.ed[i - 1] * c.ed[i - 1]) - kbt_chain)
          * inv_mi;
      d = (d + eddi * dtc4) * expfac;
      if (link[i]) {
        c.ed[i] = d;
        c.edd[i] = eddi;
      }
    }
  }
  *ke_io = ke;
  return vscale;
}

template <typename T>
__device__ void round_chain(Chain& c, int M) {
  for (int i = 0; i < M; ++i) {
    c.eta[i] = rnd<T>(c.eta[i]);
    c.ed[i] = rnd<T>(c.ed[i]);
    c.edd[i] = rnd<T>(c.edd[i]);
  }
}

template <typename T>
struct Args {
  int mode, rows, B, M, steps, G;
  double dt, m01;
  const T* ke;          // (rows,) measured 2 KE (first half) or ke_a
  const T* vs;          // (rows,) vs_a (second half alone)
  const T* eta;         // (rows, M)
  const T* eta_dot;     // (rows, M + 1)
  const T* eta_dot_dot; // (rows, M)
  const T* eta_mass;    // (B, M)
  const T* nkbt;        // (B,)
  const T* kbt_chain;   // (B,)
  const uint8_t* link;  // (B, M)
  const T* mom;         // (R, 3) CM momentum, with kCm
  const T* total_mass;  // (R,), with kCm
  T* scale;             // (rows,) the velocity scale
  T* ke_out;            // (rows,) ke_a (may be null)
  T* shift;             // (R, 3) the CM shift, with kSecond | kCm
  T* eta_out;
  T* eta_dot_out;
  T* eta_dot_dot_out;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) nh_chain_kernel(Args<T> a) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= a.rows) return;
  const int M = a.M;
  const int b = row % a.B;
  const int r = row / a.B;
  const T* em = a.eta_mass + b * M;
  const uint8_t* lk = a.link + b * M;
  const double nkbt = (double)a.nkbt[b];
  const double kbt_chain = (double)a.kbt_chain[b];
  Chain c;
  for (int i = 0; i < M; ++i) {
    c.eta[i] = (double)a.eta[row * M + i];
    c.edd[i] = (double)a.eta_dot_dot[row * M + i];
  }
  for (int i = 0; i <= M; ++i)
    c.ed[i] = (double)a.eta_dot[row * (M + 1) + i];
  const bool cm_row = (a.mode & kCm) && b == a.G;
  double v[3] = {0.0, 0.0, 0.0};
  double tm = 0.0;
  if (cm_row) {
    tm = (double)a.total_mass[r];
    for (int k = 0; k < 3; ++k) v[k] = (double)a.mom[r * 3 + k] / tm;
  }
  double ke_a = (double)a.ke[row];
  double vs_a;
  if (a.mode & kFirst) {
    vs_a = rnd<T>(half_step<T>(c, &ke_a, em, nkbt, kbt_chain, lk, M,
                               a.steps, a.dt));
    ke_a = rnd<T>(ke_a);
    round_chain<T>(c, M);
    if (cm_row) {
      const double sx = vs_a * v[0], sy = vs_a * v[1], sz = vs_a * v[2];
      ke_a = rnd<T>(ke_a - a.m01 * tm * (sx * sx + sy * sy + sz * sz));
    }
  } else {
    vs_a = (double)a.vs[row];
  }
  double scale = vs_a;
  if (a.mode & kSecond) {
    double ke_b = ke_a;
    const double vs_b = rnd<T>(half_step<T>(c, &ke_b, em, nkbt, kbt_chain,
                                            lk, M, a.steps, a.dt));
    round_chain<T>(c, M);
    scale = vs_a * vs_b;
    if (cm_row) {
      const double f = a.m01 * vs_b * vs_a;
      for (int k = 0; k < 3; ++k) a.shift[r * 3 + k] = (T)(f * v[k]);
    }
  }
  a.scale[row] = (T)scale;
  if (a.ke_out != nullptr) a.ke_out[row] = (T)ke_a;
  for (int i = 0; i < M; ++i) {
    a.eta_out[row * M + i] = (T)c.eta[i];
    a.eta_dot_dot_out[row * M + i] = (T)c.edd[i];
  }
  for (int i = 0; i <= M; ++i)
    a.eta_dot_out[row * (M + 1) + i] = (T)c.ed[i];
}

template <typename T>
int launch(int mode, int rows, int B, int M, int steps, int G, double dt,
           double m01, const void* ke, const void* vs, const void* eta,
           const void* eta_dot, const void* eta_dot_dot,
           const void* eta_mass, const void* nkbt, const void* kbt_chain,
           const void* link, const void* mom, const void* total_mass,
           void* scale, void* ke_out, void* shift, void* eta_out,
           void* eta_dot_out, void* eta_dot_dot_out, cudaStream_t stream) {
  Args<T> a;
  a.mode = mode;
  a.rows = rows;
  a.B = B;
  a.M = M;
  a.steps = steps;
  a.G = G;
  a.dt = dt;
  a.m01 = m01;
  a.ke = (const T*)ke;
  a.vs = (const T*)vs;
  a.eta = (const T*)eta;
  a.eta_dot = (const T*)eta_dot;
  a.eta_dot_dot = (const T*)eta_dot_dot;
  a.eta_mass = (const T*)eta_mass;
  a.nkbt = (const T*)nkbt;
  a.kbt_chain = (const T*)kbt_chain;
  a.link = (const uint8_t*)link;
  a.mom = (const T*)mom;
  a.total_mass = (const T*)total_mass;
  a.scale = (T*)scale;
  a.ke_out = (T*)ke_out;
  a.shift = (T*)shift;
  a.eta_out = (T*)eta_out;
  a.eta_dot_out = (T*)eta_dot_out;
  a.eta_dot_dot_out = (T*)eta_dot_dot_out;
  const int blocks = (rows + kThreads - 1) / kThreads;
  nh_chain_kernel<T><<<blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nh_chain_max_links() { return kMaxChain; }

// out[0..3]: registers a thread, static shared memory, the most threads a
// CTA may have and local memory a thread of the float (is_double = 0) or
// double instantiation, as compiled for the card.
extern "C" int nh_chain_attributes(int* out, int is_double) {
  cudaFuncAttributes a;
  cudaError_t err = is_double
      ? cudaFuncGetAttributes(&a, nh_chain_kernel<double>)
      : cudaFuncGetAttributes(&a, nh_chain_kernel<float>);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.sharedSizeBytes;
  out[2] = a.maxThreadsPerBlock;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

// mode: kFirst | kSecond | kCm bits.  rows = R * B (R replicas of B =
// G + 2 baths, replica-major), M links (1..kMaxChain), G the COM bath's
// row within a replica, dt the step size (ps), m01 1 or 0 (whether this
// step removes the CM motion).  ke: (rows,) the measured 2 KE with
// kFirst, else ke_a; vs: (rows,) vs_a without kFirst (else unread);
// mom (R, 3) and total_mass (R,) read with kCm; shift (R, 3) written with
// kSecond | kCm; ke_out (rows,) ke_a, where not null.  Every array in T
// (float for is_double = 0) but link (bytes).
extern "C" int nh_chain(int is_double, int mode, int rows, int B, int M,
                        int steps, int G, double dt, double m01,
                        const void* ke, const void* vs, const void* eta,
                        const void* eta_dot, const void* eta_dot_dot,
                        const void* eta_mass, const void* nkbt,
                        const void* kbt_chain, const void* link,
                        const void* mom, const void* total_mass,
                        void* scale, void* ke_out, void* shift,
                        void* eta_out, void* eta_dot_out,
                        void* eta_dot_dot_out, void* stream) {
  if (M < 1 || M > kMaxChain || rows < 1 || B < 1 || steps < 1 ||
      rows % B != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return is_double
      ? launch<double>(mode, rows, B, M, steps, G, dt, m01, ke, vs, eta,
                       eta_dot, eta_dot_dot, eta_mass, nkbt, kbt_chain,
                       link, mom, total_mass, scale, ke_out, shift, eta_out,
                       eta_dot_out, eta_dot_dot_out, s)
      : launch<float>(mode, rows, B, M, steps, G, dt, m01, ke, vs, eta,
                      eta_dot, eta_dot_dot, eta_mass, nkbt, kbt_chain, link,
                      mom, total_mass, scale, ke_out, shift, eta_out,
                      eta_dot_out, eta_dot_dot_out, s);
}
