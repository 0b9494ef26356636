// Moment-curve kernels for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/moment_curves/kernel.py:
//   * mc_rows -> _kernel      (per-row E[L_t], V[L_t] on the horizon grid)
//   * mc_agg  -> _agg_kernel  (the same curves summed over rows weighted by
//                              ALIVE: the cluster aggregate refresh)
//
// Two ways a row's parameters arrive (a loader each), one curve body
// (row_from, d_term, curve_point) for both:
//   * PackedRow: the TPU kernel's interface, 16 packed float columns a row
//     (layout in ../ref.py), packed on the host by core.moments.pack_belief.
//   * BeliefRow: the slot table as it is held, seven float32 columns (mu_a,
//     mu_b, lam_a, lam_b, sig_a, sig_b, cores) and the bool ALIVE column.
//     The kernel computes pack_belief's factors itself: the TPU kernel packs
//     on the host only because gammaln has no Pallas lowering, and lgammaf
//     is a device function here. The pack rounds like pack_belief's
//     separate float32 ops: every step is an explicit __f*_rn intrinsic (no
//     FMA contraction), and the scalars nu, float(nu - 1), float(2 nu),
//     float(2 nu - 2) and delta are formed in double on the host and rounded
//     once, as a Python scalar reaches a float32 PyTorch op. ref.py's
//     pack_in_kernel_order repeats this pack op for op on the CPU, and the
//     tests hold it bit for bit against pack_belief.
//
// What bounds them on this card. At the simulator's shapes (aggregate:
// D = 8,192 rows, N = 48 points, ND = 24 checkpoints; candidates: D = 8) a
// call moves a few hundred kilobytes and does a few times 10^7 operations,
// under a microsecond of memory or FP32 time at the card's peaks. What
// takes the time is instruction issue: the accurate log1pf, expm1f and expf
// of one grid point compile to about 330 instructions (the peak counts each
// as one operation), so the aggregate's points keep every scheduler busy for
// several microseconds; then the launch, and for the aggregate the sum
// across CTAs.
//
// What the design does about it.
//   * A CTA stages its rows in shared memory first: each thread loads one
//     element, neighbouring threads neighbouring addresses. The belief form
//     then packs each row with four threads: one lgammaf, one expf and two
//     divisions a thread where the plain version makes four, three and six,
//     the argument picked by the thread, shuffles handing the results round.
//   * The D-term's 2 ND survival terms a row (lag midpoints and
//     checkpoints) need only a and b: the threads that do not pack compute
//     all of the CTA's while the pack runs. Then a checkpoint per lane (two
//     when a row has 16 lanes): the TPU kernel's tril matmuls for the lag
//     cumsum and the log-space cumprod are segmented shuffle scans; the
//     hat-weight matmul is a two-point read of the row's checkpoints in
//     shared memory (idx/frac from the launcher). One division by b a row
//     for the points: they multiply by its reciprocal.
//   * Rows kernel: one warp a row, the CTA sized to the rows (the
//     simulator's 8 candidates are one CTA of 8 warps).
//   * Aggregate: one launch, one wave. A row takes 16 lanes, a warp two
//     rows, so N = 48 points are three a lane and no lane idles. CTAs of 32
//     warps, as many as the card holds at once (the launcher sizes the grid
//     from cudaOccupancyMaxActiveBlocksPerMultiprocessor): 8,192 rows are 128
//     CTAs, one an SM, every row in flight at once. Past one wave each CTA
//     strides over blocks of 64 rows and loads the next block's columns
//     before the current block's math. The sum has a fixed order: the two
//     rows of a warp, the warp's rows in turn, the CTA's warps in order,
//     then the CTAs in a fixed order inside the same launch. The launch is
//     cooperative (every CTA resident); each CTA writes its partial sums,
//     all meet at a grid barrier, and then output k is added up by one warp
//     of CTA k % grid (lane j takes CTAs j, j + 32, ... in turn, then a
//     butterfly over the lanes), so each CTA reads a few hundred bytes of
//     partials (a last CTA adding every partial alone, after a ticket,
//     read 48 KB through one SM and took longer: PERF.md). The barrier's
//     count wraps back to 0 (atomicInc) at every launch, CUDA-graph
//     replays included; each stream has its own barrier (the launcher picks
//     the slot), so launches in flight never share one.
//     No float atomics: the result is bitwise equal from run to run.
//   * Runs (mc_agg_belief: R slot tables of D rows, [R, D] columns, out
//     [R, 2N]): the TPU kernel got a run axis from vmap over its grid; here
//     it is one launch for all R runs, each summed exactly as a one-run
//     launch sums it. A run keeps its own virtual grid of g CTAs (g the
//     one-run launch's grid for D rows); the one wave of physical CTAs walks
//     the R g (run, virtual CTA) items in turn, writes each item's partials
//     to [R, 2N, g] and clears its sums, and after the one grid barrier each
//     (run, output) is added in the same lane order. The one-run launches
//     are the case R = 1 of the same kernel, so a run's result has the bits
//     of a one-run launch on its rows.
//   * Grids of more than kAggMaxN points (the paper's 5 x 600-point
//     cascade): the launcher runs one launch a chunk of at most kAggMaxN
//     points, each on its slice of t / idx / frac. The checkpoint spacing
//     is the whole grid's (t_last points at its last point), and a point's
//     sum order depends on neither the chunk nor N, so a chunk's columns
//     have the bits of a launch over any grid that holds them.
//
// Build without --use_fast_math: the closed forms rely on accurate log1pf,
// expm1f and lgammaf, and the pack on IEEE division.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 16;
// packed parameter columns, as in kernels/moment_curves/ref.py
enum Col { A = 0, B, C0, EU, EU2, EL, ES1, ESS2, RH1, Z1, RK, Z2, EMUNU,
           DELTA, ALIVE };

constexpr int kRowsWarps = 8;        // rows kernel: warps (rows) per CTA
constexpr int kAggWarps = 32;        // aggregate: warps per CTA
constexpr int kAggLanes = 16;        // aggregate: lanes per row
constexpr int kAggRowsPerCta = kAggWarps * 32 / kAggLanes;
constexpr int kMaxNd = 32;           // D-term checkpoints
constexpr int kFStride = 2 * kMaxNd + 1;   // a row's survival terms, padded
                                           // against shared-memory bank
                                           // conflicts
constexpr int kAggMaxN = 256;        // aggregate grid points
constexpr int kBarrierSlots = 64;    // aggregate grid barriers: one a stream
constexpr int kFinalLoads = 5;       // partials a lane loads at once
constexpr float kPMax = 1.0f - 1e-7f;   // survival clamp before log1p(-p)
constexpr float kFactorMin = 1e-37f;    // D-term factor clamp (TPU kernel's)
constexpr float kEps = 1e-12f;          // core/moments.py _EPS
constexpr unsigned kFull = 0xffffffffu;

// the aggregate's grid barriers, one for each stream (kBarrierSlots): the
// CTAs that have arrived
__device__ unsigned int g_barrier[kBarrierSlots];

struct Row {
  float a, b, c, eu, eu2, el, es1, ess2, rh1, z1, rk, z2, emunu, delta, alive;
  float inv_b;   // 1 / b: one division a row, not one a point
};

// Each lane takes the value of lane `src` of its group of W neighbouring
// lanes. Every lane of the warp calls it.
template <int W>
__device__ __forceinline__ float bcast(float v, int src) {
  return __shfl_sync(kFull, v, src, W);
}

// --- how a row's parameters arrive -----------------------------------------
// A CTA stages its block of R rows in shared memory before the math:
//   load(e, base, row0, R, d): element e of the block of rows row0 ..
//     row0+R-1 of the table of d rows that starts at row base (a run's),
//     the thread e's one load, neighbouring threads on neighbouring
//     addresses; rows past d read as 1 (benign, never summed or stored);
//   put(e, v, R, raw_s, rows_s): its place in shared memory;
//   pack(warp, lane, R, raw_s, rows_s): whole warps turn the staged
//     elements into packed rows in rows_s ([R][16], ref.py's layout);
//   pack_threads(R): the threads (whole warps, from 0) that pack;
//   ab(r, R, raw_s, rows_s): row r's a and b, before the pack is done.

struct PackedRow {
  static constexpr int kRaw = kCols;   // elements staged a row
  const float* __restrict__ params;    // [D, 16]

  __device__ __forceinline__ float load(int e, size_t base, int row0, int,
                                        int d) const {
    return row0 + e / kCols < d
               ? __ldg(params + (base + row0) * kCols + e)
               : 1.0f;
  }
  __device__ __forceinline__ void put(int e, float v, int, float*,
                                      float* rows_s) const {
    rows_s[e] = v;
  }
  __device__ __forceinline__ void pack(int, int, int, const float*,
                                       float*) const {}
  __device__ __forceinline__ int pack_threads(int) const { return 0; }
  // row r's a and b, staged
  __device__ __forceinline__ float2 ab(int r, int, const float*,
                                       const float* rows_s) const {
    return make_float2(rows_s[r * kCols + A], rows_s[r * kCols + B]);
  }
};

// The pack's scalars, each rounded once to float from a double on the host.
struct PackConsts {
  float nu, nu_m1, two_nu, two_nu_m2, delta;
};

__device__ __forceinline__ float clamp_away_from_zero(float z) {
  return fabsf(z) < kEps ? kEps : z;
}

struct BeliefRow {
  static constexpr int kRaw = 8;       // 7 float columns and ALIVE
  // mu_a, mu_b, lam_a, lam_b, sig_a, sig_b, cores: float32 [D] each
  const float* __restrict__ col[7];
  const unsigned char* __restrict__ alive;   // torch.bool [D]; null: all 1
  PackConsts k;

  // element e = column c, row r: c = e / R, r = e % R (raw_s[c][r])
  __device__ __forceinline__ float load(int e, size_t base, int row0, int R,
                                        int d) const {
    const int c = e / R, row = row0 + e % R;
    if (row >= d) return 1.0f;
    const float* p = col[0];
#pragma unroll
    for (int i = 1; i < 7; ++i)   // constant indices: no local copy of col
      if (c == i) p = col[i];
    if (c < 7) return __ldg(p + base + row);
    return alive == nullptr ? 1.0f : (float)__ldg(alive + base + row);
  }
  __device__ __forceinline__ void put(int e, float v, int, float* raw_s,
                                      float*) const {
    raw_s[e] = v;
  }
  __device__ __forceinline__ float2 ab(int r, int R, const float* raw_s,
                                       const float*) const {
    return make_float2(raw_s[r], raw_s[R + r]);
  }

  // whole warps, four threads a row
  __device__ __forceinline__ int pack_threads(int R) const {
    return (4 * R + 31) / 32 * 32;
  }

  // pack_belief, four threads a row: thread q = i % 4 computes factor q of
  // each lane-parallel step (one lgammaf, one expf, two divisions where the
  // plain version makes four, three and six), and shuffles among the four
  // hand the results round; thread q then stores columns q, q+4, q+8, q+12.
  __device__ __forceinline__ void pack(int warp, int lane, int R,
                                       const float* raw_s,
                                       float* rows_s) const {
    if (warp * 32 >= 4 * R) return;    // whole warps; the rest wait
    const int i = warp * 32 + lane, q = i & 3;
    const int r = min(i >> 2, R - 1);
    const float a = raw_s[r], b = raw_s[R + r];
    const float lam_a = raw_s[2 * R + r], lam_b = raw_s[3 * R + r];
    const float sig_a = raw_s[4 * R + r], sig_b = raw_s[5 * R + r];

    // E[lam], E[lam^2], E[sig], E[sig^2] (_lam_moments, _sigma_moments):
    // x / y, or x (x + 1) / (y y)
    const float x = q < 2 ? lam_a : sig_a;
    const float y = q < 2 ? lam_b : sig_b;
    const float num = (q & 1) ? __fmul_rn(x, __fadd_rn(x, 1.0f)) : x;
    const float den = (q & 1) ? __fmul_rn(y, y) : y;
    const float mom = __fdiv_rn(num, den);

    const float z1 = clamp_away_from_zero(__fsub_rn(__fadd_rn(a, k.nu), 1.0f));
    const float z2 =
        clamp_away_from_zero(__fsub_rn(__fadd_rn(a, k.two_nu), 2.0f));
    // lgamma of a, z1 + 1, z2 + 1, a + nu
    const float g_arg = q == 0 ? a
                        : q == 1 ? __fadd_rn(z1, 1.0f)
                        : q == 2 ? __fadd_rn(z2, 1.0f)
                                 : __fadd_rn(a, k.nu);
    const float lg = lgammaf(g_arg);
    const float lg_a = bcast<4>(lg, 0);
    const float lg_p = bcast<4>(lg, (q + 1) & 3);   // q = 3: unused
    const float log_b = logf(b);
    // rh1 = exp(lgamma(z1 + 1) - lgamma(a) - (nu - 1) log b) / z1,
    // rk  = exp(lgamma(z2 + 1) - lgamma(a) - (2 nu - 2) log b) / z2,
    // E[mu^nu] = exp(lgamma(a + nu) - lgamma(a) - nu log b)
    const float p = q == 0 ? k.nu_m1 : q == 1 ? k.two_nu_m2 : k.nu;
    const float e = expf(__fsub_rn(__fsub_rn(lg_p, lg_a), __fmul_rn(p, log_b)));
    const float fac = __fdiv_rn(e, q == 0 ? z1 : q == 1 ? z2 : 1.0f);

    const float el = bcast<4>(mom, 0), el2 = bcast<4>(mom, 1);
    const float es = bcast<4>(mom, 2), es2 = bcast<4>(mom, 3);
    const float es1 = __fadd_rn(es, 1.0f);
    const float ess2 = __fadd_rn(es2, __fmul_rn(2.0f, es));
    const float f[kCols] = {
        a, b, raw_s[6 * R + r], __fmul_rn(el, es1),
        __fmul_rn(el2, __fadd_rn(ess2, 1.0f)), el, es1, ess2,
        bcast<4>(fac, 0), z1, bcast<4>(fac, 1), z2, bcast<4>(fac, 2),
        k.delta, raw_s[7 * R + r], 0.0f};
    if (i >= 4 * R) return;
#pragma unroll
    for (int m = 0; m < kCols; m += 4)   // constant indices into f
      rows_s[r * kCols + m + q] = q == 0   ? f[m]
                                  : q == 1 ? f[m + 1]
                                  : q == 2 ? f[m + 2]
                                           : f[m + 3];
  }
};

// A packed row from shared memory.
__device__ __forceinline__ Row row_from(const float* p) {
  Row r;
  r.a = p[A];
  r.b = p[B];
  r.c = p[C0];
  r.eu = p[EU];
  r.eu2 = p[EU2];
  r.el = p[EL];
  r.es1 = p[ES1];
  r.ess2 = p[ESS2];
  r.rh1 = p[RH1];
  r.z1 = p[Z1];
  r.rk = p[RK];
  r.z2 = p[Z2];
  r.emunu = p[EMUNU];
  r.delta = p[DELTA];
  r.alive = p[ALIVE];
  r.inv_b = 1.0f / r.b;
  return r;
}

// --- the curve body ----------------------------------------------------------

template <int W>
__device__ __forceinline__ float group_inclusive_scan(float x, int j) {
#pragma unroll
  for (int off = 1; off < W; off <<= 1) {
    float y = __shfl_up_sync(kFull, x, off, W);
    if (j >= off) x += y;
  }
  return x;
}

// The checkpoint values of lane j, P = 32 / W of them (checkpoints
// j P .. j P + P - 1), scanned across the group: local running sums, then
// the lanes' totals scanned, then each lane adds the lanes before it.
template <int W>
__device__ __forceinline__ void group_scan(float (&x)[32 / W], int j) {
  constexpr int P = 32 / W;
#pragma unroll
  for (int p = 1; p < P; ++p) x[p] += x[p - 1];
  const float incl = group_inclusive_scan<W>(x[P - 1], j);
  float before = __shfl_up_sync(kFull, incl, 1, W);
  if (j == 0) before = 0.0f;
#pragma unroll
  for (int p = 0; p < P - 1; ++p) x[p] += before;
  x[P - 1] = incl;
}

// The D-term's survival terms of the CTA's R rows: f_s[r][m] =
// log1p(-min(P, pmax)) with P = (1 + x_m / b_r)^-a_r at x_m = (m + 1) w / 2,
// m < 2 nd: even m are the lag midpoints w (i + 1/2), odd m the checkpoints
// w (i + 1). They need only each row's a and b, so they run while the pack
// does, on the threads from `first` on (those that do not pack): thread u
// takes row u % R and every (T / R)-th term of it from u / R, T the
// threads. The caller's barrier orders f_s before d_term reads it.
template <class Loader>
__device__ __forceinline__ void survival_terms(const Loader& ld, int R,
                                               float w, int nd, int first,
                                               const float* raw_s,
                                               const float* rows_s,
                                               float* f_s) {
  const int u = (int)threadIdx.x - first;
  const int per_row = ((int)blockDim.x - first) / R;
  if (u < 0 || u >= per_row * R) return;
  const int r = u % R;
  const float2 ab = ld.ab(r, R, raw_s, rows_s);
  const float hw = 0.5f * w, inv_b = 1.0f / ab.y;
  for (int m = u / R; m < 2 * nd; m += per_row) {
    const float p = expf(-ab.x * log1pf((float)(m + 1) * hw * inv_b));
    f_s[r * kFStride + m] = log1pf(-fminf(p, kPMax));
  }
}

// E[D] at the checkpoints t_i = (i+1) w, i < nd, into ed_ext[1..nd], with
// the (t = 0, 1) anchor in ed_ext[0], from survival_terms' f_s. Every lane of
// the warp calls it.
template <int W>
__device__ __forceinline__ void d_term(const Row& r, float w, int nd, int j,
                                       const float* f_s, float* ed_ext) {
  constexpr int P = 32 / W;
  float s[P], self_dead[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int i = j * P + p;
    s[p] = self_dead[p] = 0.0f;
    if (i < nd) {
      s[p] = (r.eu * r.emunu * w) * f_s[2 * i];
      self_dead[p] = r.c * f_s[2 * i + 1];
    }
  }
  group_scan<W>(s, j);                             // lag cumsum
  float log_factor[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    log_factor[p] = 0.0f;
    if (j * P + p < nd)
      log_factor[p] =
          logf(fmaxf(-expm1f(self_dead[p] + s[p]), kFactorMin));
  }
  group_scan<W>(log_factor, j);                    // cumprod in logs
#pragma unroll
  for (int p = 0; p < P; ++p)
    if (j * P + p < nd) ed_ext[j * P + p + 1] = expf(log_factor[p]);
  if (j == 0) ed_ext[0] = 1.0f;
  __syncwarp();
}

// EL, VL of one row at grid point t, the D-term interpolated between
// checkpoints i and i+1 with weight fr on the right one.
__device__ __forceinline__ void curve_point(const Row& r, float t, int i,
                                            float fr, const float* ed_ext,
                                            float* el_out, float* vl_out) {
  const float x = t * r.inv_b;
  float l1 = log1pf(x);
  float l2 = log1pf(2.0f * x);
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
  float em = expf(-r.a * log1pf(r.delta * x));
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

// --- the kernels -------------------------------------------------------------

// Grid barrier of a cooperative launch (every CTA resident at once). Thread
// 0 of each CTA takes a ticket with atomicInc, which wraps the count back to
// 0 with the last ticket; the other CTAs wait for that 0. Nothing touches
// the count again until every CTA of the launch has left, so it is 0 at the
// next launch, CUDA-graph replays included. The CTA's writes before the
// barrier, ordered before thread 0's ticket by __syncthreads, are released
// with it and acquired by every CTA that leaves (as cooperative groups'
// grid barrier does, one fenced atomic a CTA).
__device__ __forceinline__ void grid_barrier(unsigned* count, unsigned n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned ticket, now;
    asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
                 : "=r"(ticket) : "l"(count), "r"(n - 1) : "memory");
    if (ticket != n - 1) {
      do {
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                     : "=r"(now) : "l"(count) : "memory");
      } while (now != 0);
    }
  }
  __syncthreads();
}

// One warp per row; blockDim.x / 32 rows per CTA.
template <class Loader>
__global__ void __launch_bounds__(kRowsWarps * 32)
rows_kernel(Loader ld, const float* __restrict__ t,
            const int* __restrict__ idx, const float* __restrict__ frac,
            int d, int n, int nd, float* __restrict__ el,
            float* __restrict__ vl) {
  __shared__ float raw_s[kRowsWarps * kCols];
  __shared__ float rows_s[kRowsWarps][kCols];
  __shared__ float f_s[kRowsWarps][kFStride];
  __shared__ float ed_s[kRowsWarps][kMaxNd + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows = blockDim.x >> 5, row0 = blockIdx.x * rows;
  const float w = t[n - 1] / (float)nd;
  if (threadIdx.x < rows * Loader::kRaw)
    ld.put(threadIdx.x, ld.load(threadIdx.x, 0, row0, rows, d), rows, raw_s,
           &rows_s[0][0]);
  __syncthreads();
  // the pack (first warp) and the survival terms (the others) run together
  const int packers = ld.pack_threads(rows);
  ld.pack(warp, lane, rows, raw_s, &rows_s[0][0]);
  survival_terms(ld, rows, w, nd, packers < (int)blockDim.x ? packers : 0,
                 raw_s, &rows_s[0][0], &f_s[0][0]);
  __syncthreads();
  const int row = row0 + warp;
  if (row >= d) return;   // whole warps, after the last CTA barrier
  const Row r = row_from(rows_s[warp]);
  d_term<32>(r, w, nd, lane, f_s[warp], ed_s[warp]);
  for (int k = lane; k < n; k += 32) {
    float e, v;
    curve_point(r, t[k], idx[k], frac[k], ed_s[warp], &e, &v);
    el[(size_t)row * n + k] = e;
    vl[(size_t)row * n + k] = v;
  }
}

// Masked aggregate over `runs` tables of d rows each (run r's rows start at
// row r d of every column): out[r 2n : r 2n + n] = run r's EL, the next n
// its VL. Run r has a virtual grid of g CTAs: virtual CTA c takes the
// blocks of kAggRowsPerCta rows c, c + g, ... of its run, half h of warp w
// row 2w + h of each. The gridDim.x physical CTAs (one wave) take the runs
// g items (run r, virtual CTA c), item i = r g + c, in turns: CTA p the
// items p, p + gridDim.x, ... partial is [runs][2n][g] scratch.
template <class Loader>
__global__ void __launch_bounds__(kAggWarps * 32, 1)
agg_kernel(Loader ld, const float* __restrict__ t,
           const int* __restrict__ idx, const float* __restrict__ frac,
           const float* __restrict__ t_last, int runs, int d, int n, int nd,
           int g, float* __restrict__ partial, float* __restrict__ out,
           int slot) {
  extern __shared__ float acc_s[];                  // [kAggWarps][2n]
  __shared__ float raw_s[kAggRowsPerCta * kCols];
  __shared__ float rows_s[kAggRowsPerCta][kCols];
  __shared__ float f_s[kAggRowsPerCta][kFStride];
  __shared__ float ed_s[kAggWarps][2][kMaxNd + 1];
  constexpr int kStaged = kAggRowsPerCta * Loader::kRaw;
  static_assert(kStaged <= kAggWarps * 32, "one staged element a thread");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = lane >> 4, j = lane & (kAggLanes - 1);
  const int my = warp * 2 + half;                   // row in the block
  const int items = runs * g, ctas = gridDim.x;
  float* acc = acc_s + (size_t)warp * 2 * n;
  for (int k = lane; k < 2 * n; k += 32) acc[k] = 0.0f;

  const float w = *t_last / (float)nd;
  const int stride = g * kAggRowsPerCta;
  // the CTA's place: item `item`, the block of rows from row0 of its run
  int item = blockIdx.x;
  int row0 = item % g * kAggRowsPerCta;
  float raw = tid < kStaged && item < items
                  ? ld.load(tid, (size_t)(item / g) * d, row0,
                            kAggRowsPerCta, d)
                  : 0.0f;
  while (item < items) {
    // the next place, and its block's columns loaded before this block's
    // math
    int next_item = item, next_row0 = row0 + stride;
    if (next_row0 >= d) {
      next_item = item + ctas;
      next_row0 = next_item % g * kAggRowsPerCta;
    }
    const float next_raw =
        tid < kStaged && next_item < items
            ? ld.load(tid, (size_t)(next_item / g) * d, next_row0,
                      kAggRowsPerCta, d)
            : 0.0f;
    if (tid < kStaged) ld.put(tid, raw, kAggRowsPerCta, raw_s, &rows_s[0][0]);
    __syncthreads();
    // the pack (first warps) and the survival terms (the others) together
    ld.pack(warp, lane, kAggRowsPerCta, raw_s, &rows_s[0][0]);
    survival_terms(ld, kAggRowsPerCta, w, nd, ld.pack_threads(kAggRowsPerCta),
                   raw_s, &rows_s[0][0], &f_s[0][0]);
    __syncthreads();
    const bool valid = row0 + my < d;
    const Row r = row_from(rows_s[my]);
    d_term<kAggLanes>(r, w, nd, j, f_s[my], ed_s[warp][half]);
    // every lane runs every pass (the shuffles need the whole warp); lanes
    // past the last point compute point n - 1 and drop it
    for (int k0 = 0; k0 < n; k0 += kAggLanes) {
      const int k = min(k0 + j, n - 1);
      const bool mine = valid && k0 + j < n;
      float e, v;
      curve_point(r, t[k], idx[k], frac[k], ed_s[warp][half], &e, &v);
      e = mine ? e * r.alive : 0.0f;
      v = mine ? v * r.alive : 0.0f;
      e += __shfl_down_sync(kFull, e, 16);          // the warp's two rows
      v += __shfl_down_sync(kFull, v, 16);
      if (half == 0 && k0 + j < n) {
        acc[k] += e;
        acc[n + k] += v;
      }
    }
    __syncthreads();   // staged rows, ed_s and the sums read before they
                       // are rewritten
    if (next_item != item) {
      // the item is done: its CTA sum (the warps in order) to partial, and
      // the sums cleared for the next item; thread k alone touches column k
      float* pr = partial + (size_t)(item / g) * 2 * n * g + item % g;
      for (int k = tid; k < 2 * n; k += blockDim.x) {
        float s = 0.0f;
        for (int wi = 0; wi < kAggWarps; ++wi) {
          s += acc_s[(size_t)wi * 2 * n + k];
          acc_s[(size_t)wi * 2 * n + k] = 0.0f;
        }
        pr[(size_t)k * g] = s;
      }
    }
    item = next_item;
    row0 = next_row0;
    raw = next_raw;
  }

  grid_barrier(&g_barrier[slot], ctas);
  // output o = r 2n + k: CTA o % ctas, warp o / ctas % kAggWarps; lane c adds
  // the run's virtual CTAs c, c + 32, ... in turn (its first kFinalLoads
  // partials loaded together), then a butterfly over the lanes
  for (int o = blockIdx.x + ctas * warp; o < runs * 2 * n;
       o += ctas * kAggWarps) {
    const float* pk = partial + (size_t)o * g;
    float v[kFinalLoads];
#pragma unroll
    for (int m = 0; m < kFinalLoads; ++m) {
      const int c = lane + 32 * m;
      v[m] = c < g ? __ldcg(pk + c) : 0.0f;
    }
    float s = 0.0f;
#pragma unroll
    for (int m = 0; m < kFinalLoads; ++m)
      if (lane + 32 * m < g) s += v[m];
    for (int c = lane + 32 * kFinalLoads; c < g; c += 32) s += __ldcg(pk + c);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(kFull, s, off);
    if (lane == 0) out[o] = s;
  }
}

__global__ void empty_kernel() {}

constexpr size_t agg_smem_bytes(int n) {
  return (size_t)kAggWarps * 2 * n * sizeof(float);
}

// Opt in to the dynamic shared memory the largest grid needs, once per
// instance and device (repeating it is harmless).
template <class Loader>
cudaError_t agg_prepare() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(agg_kernel<Loader>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)agg_smem_bytes(kAggMaxN));
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <class Loader>
int launch_rows(const Loader& ld, const float* t, const int* idx,
                const float* frac, int d, int n, int nd, float* el,
                float* vl, void* stream) {
  const int warps = d < kRowsWarps ? d : kRowsWarps;
  const int blocks = (d + warps - 1) / warps;
  rows_kernel<Loader><<<blocks, warps * 32, 0, (cudaStream_t)stream>>>(
      ld, t, idx, frac, d, n, nd, el, vl);
  return (int)cudaGetLastError();
}

// `runs` tables of d rows on a virtual grid of g CTAs each, run by `ctas`
// physical CTAs (one wave: at most the CTAs the card holds at once). t_last
// points at the whole grid's last point (t + n - 1 unless t is a chunk).
template <class Loader>
int launch_agg(const Loader& ld, const float* t, const int* idx,
               const float* frac, const float* t_last, int runs, int d, int n,
               int nd, int g, int ctas, float* partial, float* out, int slot,
               void* stream) {
  cudaError_t err = agg_prepare<Loader>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kAggWarps * 32);
  cfg.dynamicSmemBytes = agg_smem_bytes(n);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;   // every CTA resident: the
  attr.val.cooperative = 1;                   // grid barrier needs it
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, agg_kernel<Loader>, ld, t, idx, frac, t_last,
                           runs, d, n, nd, g, partial, out, slot);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <class Loader>
int agg_capacity(int n, int* blocks_per_sm, int* sms, int* regs,
                 int* local_bytes) {
  cudaError_t err = agg_prepare<Loader>();
  if (err != cudaSuccess) return (int)err;
  int dev;
  cudaFuncAttributes attr;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           blocks_per_sm, agg_kernel<Loader>, kAggWarps * 32,
           agg_smem_bytes(n))) != cudaSuccess ||
      (err = cudaFuncGetAttributes(&attr, agg_kernel<Loader>)) !=
          cudaSuccess)
    return (int)err;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

BeliefRow belief_row(const float* mu_a, const float* mu_b,
                     const float* lam_a, const float* lam_b,
                     const float* sig_a, const float* sig_b,
                     const float* cores, const unsigned char* alive, float nu,
                     float nu_m1, float two_nu, float two_nu_m2,
                     float delta) {
  return BeliefRow{{mu_a, mu_b, lam_a, lam_b, sig_a, sig_b, cores}, alive,
                   PackConsts{nu, nu_m1, two_nu, two_nu_m2, delta}};
}

}  // namespace

extern "C" {

int mc_agg_rows_per_cta() { return kAggRowsPerCta; }
int mc_agg_max_n() { return kAggMaxN; }
int mc_max_nd() { return kMaxNd; }
int mc_barrier_slots() { return kBarrierSlots; }

// Per-row curves from packed rows: el, vl [d, n]. Returns
// cudaGetLastError() after the launch.
int mc_rows(const float* params, const float* t, const int* idx,
            const float* frac, int d, int n, int nd, float* el, float* vl,
            void* stream) {
  return launch_rows(PackedRow{params}, t, idx, frac, d, n, nd, el, vl,
                     stream);
}

// Per-row curves from the belief columns (each float32 [d]).
int mc_rows_belief(const float* mu_a, const float* mu_b, const float* lam_a,
                   const float* lam_b, const float* sig_a, const float* sig_b,
                   const float* cores, float nu, float nu_m1, float two_nu,
                   float two_nu_m2, float delta, const float* t,
                   const int* idx, const float* frac, int d, int n, int nd,
                   float* el, float* vl, void* stream) {
  return launch_rows(belief_row(mu_a, mu_b, lam_a, lam_b, sig_a, sig_b,
                                cores, nullptr, nu, nu_m1, two_nu, two_nu_m2,
                                delta),
                     t, idx, frac, d, n, nd, el, vl, stream);
}

// Masked aggregate from packed rows: out [2n] (EL, then VL); partial is
// scratch of 2 n grid floats; grid <= the CTAs the card holds at once
// (mc_agg_capacity); slot < mc_barrier_slots(), one per stream.
int mc_agg(const float* params, const float* t, const int* idx,
           const float* frac, int d, int n, int nd, int grid, float* partial,
           float* out, int slot, void* stream) {
  return launch_agg(PackedRow{params}, t, idx, frac, t + n - 1, 1, d, n, nd,
                    grid, grid, partial, out, slot, stream);
}

// Masked aggregates from the belief columns and the bool ALIVE column, of
// `runs` runs in one launch: the columns are [runs, d] (run r's rows at
// r d; one run: runs = 1), out [runs, 2n] (each run's EL, then its VL);
// partial is scratch of runs 2 n g floats. g is a one-run launch's grid for
// d rows; ctas <= runs g and <= the CTAs the card holds at once. t, idx,
// frac may be a chunk of n <= kAggMaxN points of a longer grid whose last
// point t_last points at (t + n - 1 for a whole grid).
int mc_agg_belief(const float* mu_a, const float* mu_b, const float* lam_a,
                  const float* lam_b, const float* sig_a, const float* sig_b,
                  const float* cores, const unsigned char* alive, float nu,
                  float nu_m1, float two_nu, float two_nu_m2, float delta,
                  const float* t, const int* idx, const float* frac,
                  const float* t_last, int runs, int d, int n, int nd, int g,
                  int ctas, float* partial, float* out, int slot,
                  void* stream) {
  return launch_agg(belief_row(mu_a, mu_b, lam_a, lam_b, sig_a, sig_b, cores,
                               alive, nu, nu_m1, two_nu, two_nu_m2, delta),
                    t, idx, frac, t_last, runs, d, n, nd, g, ctas, partial,
                    out, slot, stream);
}

// The aggregate kernel's residency on the current device at n grid points
// (belief != 0: the belief form): CTAs an SM, SMs, registers a thread and
// local (spill) bytes a thread.
int mc_agg_capacity(int belief, int n, int* blocks_per_sm, int* sms,
                    int* regs, int* local_bytes) {
  return belief ? agg_capacity<BeliefRow>(n, blocks_per_sm, sms, regs,
                                          local_bytes)
                : agg_capacity<PackedRow>(n, blocks_per_sm, sms, regs,
                                          local_bytes);
}

// An empty kernel: the launch floor that chip_smoke.py times beside these.
int mc_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
