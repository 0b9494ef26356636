// Moment-curve kernels for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/moment_curves/kernel.py:
//   * mc_rows -> _kernel      (per-row E[L_t], V[L_t] on the horizon grid)
//   * mc_agg  -> _agg_kernel  (the same curves summed over rows whose ALIVE
//                              column is 1: the cluster aggregate refresh)
//
// What bounds them on this card. Each packed row is 16 floats (64 B) and
// yields N grid points of about ten transcendentals each, plus ND <= 32
// D-term checkpoints with two prefix scans. At the simulator's shapes
// (aggregate: D = 8,192 rows, N = 48; candidates: D = 8 rows) the work is
// about half a megabyte and a few times 10^7 operations, well under 10 us of
// memory or FP32 time: both kernels are bound by launch latency, not by the
// card's rates.
//
// What the design does about it. The TPU kernel expresses the D-term's lag
// cumsum and cumprod as matmuls against a tril matrix and interpolates with
// a [ND+1, N] hat-weight matmul, because the TPU's vector unit has no cheap
// scan. Here one warp owns one packed row: lane j owns checkpoint j, the
// lag cumsum and the log-space cumprod are warp inclusive scans
// (__shfl_up_sync), and each grid point reads its two neighbouring
// checkpoints from the warp's row of shared memory, with idx/frac computed
// once by the launcher. Nothing is staged through device memory except the
// aggregate's per-CTA partials. The aggregate gives each CTA a fixed run of
// 64 rows (8,192 rows -> 128 CTAs on 132 SMs), reduces its warps in fixed
// order through shared memory, and a second small kernel sums the per-CTA
// partials in CTA order: no float atomics, so the result is bitwise
// deterministic from run to run. The per-row kernel sizes its CTA to the
// rows it has, so the simulator's 8 candidates run as one CTA of 8 warps.
//
// Build without --use_fast_math: the closed forms rely on accurate log1pf
// and expm1f near zero.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 16;
// packed parameter columns, as in kernels/moment_curves/ref.py
enum Col { A = 0, B, C0, EU, EU2, EL, ES1, ESS2, RH1, Z1, RK, Z2, EMUNU,
           DELTA, ALIVE };

constexpr int kWarps = 8;            // warps per CTA
constexpr int kMaxNd = 32;           // one D-term checkpoint per lane
constexpr int kAggRowsPerCta = 64;
constexpr int kAggPerLane = 8;       // grid points per lane in the aggregate
constexpr int kAggMaxN = 32 * kAggPerLane;
constexpr float kPMax = 1.0f - 1e-7f;   // survival clamp before log1p(-p)
constexpr float kFactorMin = 1e-37f;    // D-term factor clamp (TPU kernel's)
constexpr unsigned kFull = 0xffffffffu;

struct Row {
  float a, b, c, eu, eu2, el, es1, ess2, rh1, z1, rk, z2, emunu, delta, alive;
};

// Lanes 0..15 read the row's 16 columns (one coalesced 64-byte read), then
// every lane takes each column by shuffle.
__device__ __forceinline__ Row load_row(const float* __restrict__ params,
                                        int row, int lane) {
  float v = lane < kCols ? params[(size_t)row * kCols + lane] : 0.0f;
  Row r;
  r.a = __shfl_sync(kFull, v, A);
  r.b = __shfl_sync(kFull, v, B);
  r.c = __shfl_sync(kFull, v, C0);
  r.eu = __shfl_sync(kFull, v, EU);
  r.eu2 = __shfl_sync(kFull, v, EU2);
  r.el = __shfl_sync(kFull, v, EL);
  r.es1 = __shfl_sync(kFull, v, ES1);
  r.ess2 = __shfl_sync(kFull, v, ESS2);
  r.rh1 = __shfl_sync(kFull, v, RH1);
  r.z1 = __shfl_sync(kFull, v, Z1);
  r.rk = __shfl_sync(kFull, v, RK);
  r.z2 = __shfl_sync(kFull, v, Z2);
  r.emunu = __shfl_sync(kFull, v, EMUNU);
  r.delta = __shfl_sync(kFull, v, DELTA);
  r.alive = __shfl_sync(kFull, v, ALIVE);
  return r;
}

__device__ __forceinline__ float warp_inclusive_scan(float x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    float y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// E[D] at the checkpoints t_j = (j+1) w, j < nd, into ed_ext[1..nd], with
// the (t = 0, 1) anchor in ed_ext[0]. All 32 lanes must call it.
__device__ __forceinline__ void d_term(const Row& r, float w, int nd,
                                       int lane, float* ed_ext) {
  const bool mine = lane < nd;
  const float j = (float)lane;
  float s = 0.0f, self_dead = 0.0f;
  if (mine) {
    float tau = w * (j + 0.5f);                 // midpoint lag
    float tc = (j + 1.0f) * w;                  // checkpoint time
    float p_lag = expf(-r.a * log1pf(tau / r.b));
    s = (r.eu * r.emunu * w) * log1pf(-fminf(p_lag, kPMax));
    float p_self = expf(-r.a * log1pf(tc / r.b));
    self_dead = r.c * log1pf(-fminf(p_self, kPMax));
  }
  float log_dead = self_dead + warp_inclusive_scan(s, lane);
  float log_factor = 0.0f;
  if (mine) log_factor = logf(fmaxf(-expm1f(log_dead), kFactorMin));
  float log_ed = warp_inclusive_scan(log_factor, lane);   // cumprod in logs
  if (mine) ed_ext[lane + 1] = expf(log_ed);
  if (lane == 0) ed_ext[0] = 1.0f;
  __syncwarp();
}

// EL, VL of one row at grid point t, the D-term interpolated between
// checkpoints i and i+1 with weight fr on the right one.
__device__ __forceinline__ void curve_point(const Row& r, float t, int i,
                                            float fr, const float* ed_ext,
                                            float* el_out, float* vl_out) {
  float l1 = log1pf(t / r.b);
  float l2 = log1pf(2.0f * t / r.b);
  float h1 = r.rh1 * -expm1f(-r.z1 * l1);
  float h2 = r.rh1 * -expm1f(-r.z1 * l2);
  float eq = r.eu * h1;
  float evq = r.el * (r.es1 * h1 + 0.5f * r.ess2 * h2);
  float kk = r.rk * (-2.0f * expm1f(-r.z2 * l1) + expm1f(-r.z2 * l2));
  float vq = evq + fmaxf(r.eu2 * kk - eq * eq, 0.0f);

  float p1 = expf(-r.a * l1);
  float p2 = expf(-r.a * l2);
  float eb = r.c * p1;
  float vb = r.c * (p1 - p2) + r.c * r.c * fmaxf(p2 - p1 * p1, 0.0f);
  float em = expf(-r.a * log1pf(r.delta * t / r.b));
  float vm = em * (1.0f - em);

  float ed = ed_ext[i] * (1.0f - fr) + ed_ext[i + 1] * fr;
  float vd = ed * (1.0f - ed);

  float er = eq + eb;
  float vr = vq + vb;
  float edr = ed * er;
  float vdr = vd * vr + vd * er * er + ed * ed * vr;
  *el_out = em * edr;
  *vl_out = vm * vdr + vm * edr * edr + em * em * vdr;
}

// One warp per row; blockDim.x / 32 rows per CTA.
__global__ void __launch_bounds__(kWarps * 32)
rows_kernel(const float* __restrict__ params, const float* __restrict__ t,
            const int* __restrict__ idx, const float* __restrict__ frac,
            int d, int n, int nd, float* __restrict__ el,
            float* __restrict__ vl) {
  __shared__ float ed_s[kWarps][kMaxNd + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= d) return;   // whole warps leave together; no CTA barrier below
  const Row r = load_row(params, row, lane);
  const float w = t[n - 1] / (float)nd;
  d_term(r, w, nd, lane, ed_s[warp]);
  for (int k = lane; k < n; k += 32) {
    float e, v;
    curve_point(r, t[k], idx[k], frac[k], ed_s[warp], &e, &v);
    el[(size_t)row * n + k] = e;
    vl[(size_t)row * n + k] = v;
  }
}

// kAggRowsPerCta rows per CTA, warps striding over them; writes this CTA's
// masked sums to partial[0][blockIdx.x][:] (EL) and partial[1][...] (VL).
__global__ void __launch_bounds__(kWarps * 32)
agg_kernel(const float* __restrict__ params, const float* __restrict__ t,
           const int* __restrict__ idx, const float* __restrict__ frac,
           int d, int n, int nd, float* __restrict__ partial) {
  __shared__ float ed_s[kWarps][kMaxNd + 1];
  __shared__ float red_el[kWarps][kAggMaxN];
  __shared__ float red_vl[kWarps][kAggMaxN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float w = t[n - 1] / (float)nd;
  float acc_el[kAggPerLane], acc_vl[kAggPerLane];
#pragma unroll
  for (int q = 0; q < kAggPerLane; ++q) acc_el[q] = acc_vl[q] = 0.0f;

  const int row0 = blockIdx.x * kAggRowsPerCta;
  const int row_end = min(row0 + kAggRowsPerCta, d);
  for (int row = row0 + warp; row < row_end; row += kWarps) {
    const Row r = load_row(params, row, lane);
    d_term(r, w, nd, lane, ed_s[warp]);
#pragma unroll
    for (int q = 0; q < kAggPerLane; ++q) {
      const int k = lane + 32 * q;
      if (k < n) {
        float e, v;
        curve_point(r, t[k], idx[k], frac[k], ed_s[warp], &e, &v);
        acc_el[q] += e * r.alive;
        acc_vl[q] += v * r.alive;
      }
    }
    __syncwarp();   // every lane has read ed_s[warp] before the next row
  }
#pragma unroll
  for (int q = 0; q < kAggPerLane; ++q) {
    const int k = lane + 32 * q;
    if (k < n) {
      red_el[warp][k] = acc_el[q];
      red_vl[warp][k] = acc_vl[q];
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    float se = 0.0f, sv = 0.0f;
    for (int wi = 0; wi < kWarps; ++wi) {   // fixed warp order
      se += red_el[wi][k];
      sv += red_vl[wi][k];
    }
    partial[(size_t)blockIdx.x * n + k] = se;
    partial[((size_t)gridDim.x + blockIdx.x) * n + k] = sv;
  }
}

// Sums the per-CTA partials in CTA order: one thread per grid point.
__global__ void agg_finalize(const float* __restrict__ partial, int n_blocks,
                             int n, float* __restrict__ el,
                             float* __restrict__ vl) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  float se = 0.0f, sv = 0.0f;
  for (int b = 0; b < n_blocks; ++b) {
    se += partial[(size_t)b * n + k];
    sv += partial[((size_t)n_blocks + b) * n + k];
  }
  el[k] = se;
  vl[k] = sv;
}

}  // namespace

extern "C" {

int mc_agg_rows_per_cta() { return kAggRowsPerCta; }
int mc_agg_max_n() { return kAggMaxN; }
int mc_max_nd() { return kMaxNd; }

// Per-row curves: el, vl [d, n]. Returns cudaGetLastError() after launch.
int mc_rows(const float* params, const float* t, const int* idx,
            const float* frac, int d, int n, int nd, float* el, float* vl,
            void* stream) {
  const int warps = d < kWarps ? d : kWarps;
  const int blocks = (d + warps - 1) / warps;
  rows_kernel<<<blocks, warps * 32, 0, (cudaStream_t)stream>>>(
      params, t, idx, frac, d, n, nd, el, vl);
  return (int)cudaGetLastError();
}

// Masked aggregate: el, vl [n]; partial is scratch of
// 2 * ceil(d / mc_agg_rows_per_cta()) * n floats.
int mc_agg(const float* params, const float* t, const int* idx,
           const float* frac, int d, int n, int nd, float* partial,
           float* el, float* vl, void* stream) {
  const int n_blocks = (d + kAggRowsPerCta - 1) / kAggRowsPerCta;
  cudaStream_t s = (cudaStream_t)stream;
  agg_kernel<<<n_blocks, kWarps * 32, 0, s>>>(params, t, idx, frac, d, n, nd,
                                               partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  agg_finalize<<<(n + 127) / 128, 128, 0, s>>>(partial, n_blocks, n, el, vl);
  return (int)cudaGetLastError();
}

}  // extern "C"
