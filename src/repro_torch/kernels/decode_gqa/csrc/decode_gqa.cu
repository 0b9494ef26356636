// Single-token grouped-query decode attention for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_gqa/kernel.py
// `_kernel` (wrapper `decode_gqa_grouped`, entry `ops.decode_gqa`): one new
// query per row against a KV cache, with a valid length per row, and the
// G = H / KVH query heads that share a KV head served together (up to four
// at a time, see below).
//
// What bounds it on this card. Each valid key and value row is read once
// and used for a handful of FMAs (G dot products of Dh, about 4 FLOP a
// byte), so the kernel is bound by bytes: at llama3.2-1b (B = 4, KVH = 8,
// Dh = 64, 2,048 valid keys, bf16 cache) it streams 16.8 MB, about 5 us at
// 3.35 TB/s. No tensor cores: G <= 16 rows is far under wgmma's 64.
//
// What the design does about it. One launch a call. The TPU kernel walks the
// key axis of one (batch, kv-head) pair in sequence; here B * KVH = 32 pairs
// would leave most of the 132 SMs idle, so each pair (and each pass of up to
// kMaxHeadsPerPass of its query heads) gets a thread-block cluster of kSplits =
// 8 CTAs, the portable cluster size (16, the largest an H100 launches, was
// slower: the card holds 21 clusters of 16 at once, short of the 32 a
// llama3.2-1b call needs). CTAs are small (4 warps, 3 an SM) so that every
// cluster of a llama3.2-1b call is resident at once: the card holds 45 clusters
// of 8 (`dg_max_active_clusters`); with 8-warp CTAs only 30 fit, and the last
// two ran as a second wave. A CTA reads its row's length from the device
// `lengths` tensor (the TPU's scalar prefetch) and takes its contiguous share
// of the valid range [0, len), rounded up to its key tile, so every CTA of a
// full row has work and bytes past the length are never read. Each warp streams
// its keys through its own 3-stage ring in shared memory, filled by 16-byte
// `cp.async` copies along Dh (8 bf16 or 4 float32 a lane, the cache's own
// bytes: nothing is converted on the way); a lane reads back only the pieces it
// copied, so the ring needs no barrier, and the copies of the next two stages
// are in flight while a stage is computed. q sits in registers as float32. L
// lanes share a key (8 to 32); each key's dot with each head is a shuffle
// reduction over them. Where a step's dots outnumber the lanes (llama3.2-1b: 4
// keys x 4 heads over 8 lanes) the reduction scatters, each lane runs the
// softmax of its own dots only and p goes back to every lane for P.V; else
// every lane runs all of it. The online softmax is the TPU kernel's (corr =
// exp(m_prev - m_new)), in base 2: the scale 1/sqrt(Dh) is applied after the
// dot together with log2(e), so p = exp(s - m) is one ex2. The lane groups'
// states (m, l, acc) merge in shared memory in a fixed order; each CTA stores
// its merged state, 16 bytes at a time, into the shared memory of the CTA that
// owns each output slice (distributed shared memory), and after one cluster
// barrier each CTA combines its slice from its own shared memory, in rank
// order. Nothing goes to device memory but the output: no scratch, no second
// kernel, no atomics, so the output repeats bit for bit. The cache is read in
// its [B, S, KVH, Dh] layout through strides. Output acc / max(l, 1e-30); a row
// of length 0 gives zeros, as the TPU kernel does. On request (a non-null
// `lse`) the rank that combines a head's first element also stores the
// head's log-sum-exp over its valid keys, m ln 2 + ln l from the final max and
// sum it already holds (-inf at length 0): what a caller needs to combine
// this output with others over other keys (a sequence-sharded cache).
//
// Where a KV head serves more than kMaxHeadsPerPass query heads (G = 8 or
// 16), the kernel runs ceil(G / 4) passes, each its own cluster, and each
// pass reads the KV head's valid rows again: the bytes read grow by that
// factor (2 at G = 8, 4 at G = 16), from the L2 where the passes of one KV
// head (adjacent in the grid) run at once, else from memory. The passes
// exist because q and acc of a pass's heads sit in registers (2 * GP * 8
// floats a lane for a bf16 cache at Dh 64: 64 of the instance's 128
// registers at GP = 4), and twice as many would not fit under the
// 128-register cap of `__launch_bounds__(kThreads, 4)`. At G = 8 a call
// of B * KVH = 32 pairs needs 64 clusters, past the 45 resident at once,
// so it also runs a second wave.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;          // 16-byte K pieces a lane copies a stage
constexpr int kStages = 3;          // ring stages a warp
constexpr int kStageBytes = 2 * kUnroll * 32 * 16;   // K and V, a warp
constexpr int kSplits = 8;          // CTAs a cluster: the portable size
constexpr int kMaxHeadsPerPass = 4;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* lengths;
  float* out;
  float* lse;         // [B, H] log-sum-exp of each head, or null
  int seq, n_heads, group, head_dim, q_bf16;
  long long qsb, qsh, ksb, kss, ksh, vsb, vss, vsh;
  float scale_log2;   // log2(e) / sqrt(Dh)
};

// 16 bytes from device memory into shared memory, asynchronously; with
// `copy` false nothing is read and the 16 bytes are zeros
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool copy) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(copy ? 16 : 0) : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the cluster barrier in two halves: arrive (without ordering memory) at
// the start, wait before the first store to another CTA's shared memory,
// so that every CTA of the cluster is known to run by then
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(uint4 r, float* f) {
    f[0] = __uint_as_float(r.x);
    f[1] = __uint_as_float(r.y);
    f[2] = __uint_as_float(r.z);
    f[3] = __uint_as_float(r.w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  // a bf16 is the top half of the float32 with the same value; element 0
  // of a 32-bit word is its low half
  __device__ __forceinline__ static void unpack(uint4 r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__host__ __device__ __forceinline__ int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}

// Lanes that share one key: the 16-byte pieces of a row, rounded up to a
// power of two, at least 8 (a shorter row leaves lanes idle) and at most a
// warp; NV pieces a lane when a row has more than 32.
__host__ __device__ __forceinline__ int lanes_per_key(int chunks) {
  int lanes = 8;
  while (lanes < chunks && lanes < 32) lanes <<= 1;
  return lanes;
}

// Keys a CTA covers in one step of its loop: a split's share of the valid
// range is rounded up to this.
__host__ __device__ __forceinline__ int key_tile(int elem_bytes,
                                                 int head_dim) {
  const int chunks = head_dim * elem_bytes / 16;
  const int lanes = lanes_per_key(chunks);
  const int nv = ceil_div(chunks, lanes);
  return kWarps * (32 / lanes) * (kUnroll / nv);
}

// Output elements of a pass each rank of the cluster combines: whole
// float4s, so that a rank's share arrives in 16-byte stores.
__host__ __device__ __forceinline__ int out_slice(int heads, int head_dim) {
  return ceil_div(ceil_div(heads * head_dim, kSplits), 4) * 4;
}

// Lane-group states of a CTA: each lane group's (m, l, acc) after its keys.
__host__ __device__ __forceinline__ int n_states(int lanes) {
  return kWarps * (32 / lanes);
}

size_t smem_bytes(int gp, int head_dim, int lanes) {
  // the warps' rings; lane-group states (acc [states][GP][Dh], m and l
  // [states][GP]); what the ranks send this CTA (acc [kSplits][slice],
  // m and l [kSplits][GP])
  const size_t floats =
      (size_t)n_states(lanes) * gp * (head_dim + 2) +
      (size_t)kSplits * (out_slice(gp, head_dim) + 2 * gp);
  return (size_t)kWarps * kStages * kStageBytes + sizeof(float) * floats;
}

// One level of a reduce-scatter over the lanes `off` apart, then the next:
// of the first N values, a lane keeps the upper half if its `off` bit is
// set, else the lower half, and adds its partner's copy of that half.
template <int N, int OFF, int VT>
__device__ __forceinline__ void reduce_scatter(float (&val)[VT], int lane) {
  if constexpr (OFF > 0) {
    constexpr int HALF = N / 2;
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int k = 0; k < HALF; ++k) {
      const float send = upper ? val[k] : val[HALF + k];
      const float keep = upper ? val[HALF + k] : val[k];
      val[k] = keep + __shfl_xor_sync(kFull, send, OFF);
    }
    reduce_scatter<HALF, OFF / 2>(val, lane);
  }
}

// The bits of q for the pass's heads, this lane's pieces of each row, as
// float32 bits (a bf16 is the top half of its float32). Every load is
// issued unconditionally, from a clamped address, and nothing waits for
// them here: they are in flight while the row's length is read.
template <typename TQ, int SHIFT, int NV, int GP, int VEC>
__device__ __forceinline__ void load_q_bits(const Args& a, int b, int h0,
                                            int n_g, int j, int L,
                                            int chunks,
                                            uint32_t (&bits)[GP][NV * VEC]) {
  const TQ* q = static_cast<const TQ*>(a.q);
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int nv = 0; nv < NV; ++nv)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const int c = j + nv * L;
        const bool ok = g < n_g && c < chunks;
        bits[g][nv * VEC + i] =
            (uint32_t)q[ok ? b * a.qsb + (long long)(h0 + g) * a.qsh +
                                 c * VEC + i
                           : 0]
            << SHIFT;
      }
}

template <typename TKV, int NV, int L, int GP>
__global__ void __launch_bounds__(kThreads, 4)
decode_cluster_kernel(const Args a) {
  constexpr int VEC = Vec<TKV>::kN;
  constexpr int E = NV * VEC;             // row elements a lane holds
  constexpr int U = kUnroll / NV;         // keys a lane group takes a step
  constexpr int KPW = 32 / L;             // lane groups (keys) in a warp
  constexpr int TILE = kWarps * KPW * U;  // keys a CTA takes a step
  constexpr int S = kWarps * KPW;         // lane-group states of a CTA
  constexpr int V = U * GP;               // dots of a lane group a step
  // with V >= L each lane owns C of a step's dots after the reduce-scatter:
  // key j / Q, heads (j % Q) C .. (j % Q) C + C - 1
  constexpr int C = V >= L ? V / L : 1;
  constexpr int Q = GP / C;
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int dh = a.head_dim;
  const int n_pass = ceil_div(a.group, GP);
  const int kvh = blockIdx.y / n_pass, pass = blockIdx.y % n_pass;
  const int b = blockIdx.z;
  const int n_g = min(GP, a.group - pass * GP);    // real heads this pass
  const int h0 = kvh * a.group + pass * GP;
  const int chunks = dh / VEC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / L, j = lane % L;
  const int state = warp * KPW + sub;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw + warp * kStages * kStageBytes;
  // lane-group states (acc [S][GP][Dh], m and l [S][GP]); what the ranks
  // send this CTA (acc [kSplits][slice], m and l [kSplits][GP])
  float* w_acc = reinterpret_cast<float*>(smem_raw +
                                          kWarps * kStages * kStageBytes);
  float* w_m = w_acc + S * GP * dh;
  float* w_l = w_m + S * GP;
  float* r_acc = w_l + S * GP;
  float* r_m = r_acc + kSplits * out_slice(GP, dh);
  float* r_l = r_m + kSplits * GP;

  uint32_t q_bits[GP][E];
  if (a.q_bf16)
    load_q_bits<unsigned short, 16, NV, GP, VEC>(a, b, h0, n_g, j, L, chunks,
                                                 q_bits);
  else
    load_q_bits<uint32_t, 0, NV, GP, VEC>(a, b, h0, n_g, j, L, chunks,
                                          q_bits);

  // this CTA's share of the valid keys; step t of this lane group covers
  // keys first + t * TILE + u * KPW for u < U
  const int len = min(max(a.lengths[b], 0), a.seq);
  const int per = ceil_div(ceil_div(len, kSplits), TILE) * TILE;
  const int k_begin = (int)min((long long)rank * per, (long long)len);
  const int k_end = min(k_begin + per, len);
  const int warp_first = k_begin + warp * KPW * U;
  const int n_steps =
      k_end > warp_first ? ceil_div(k_end - warp_first, TILE) : 0;
  const int first = warp_first + sub;

  const TKV* kb = static_cast<const TKV*>(a.k) + b * a.ksb + kvh * a.ksh;
  const TKV* vb = static_cast<const TKV*>(a.v) + b * a.vsb + kvh * a.vsh;
  const TKV* kp = kb + (long long)first * a.kss + j * VEC;
  const TKV* vp = vb + (long long)first * a.vss + j * VEC;
  // the pieces this lane copies for step t into ring stage `slot`; pieces
  // of keys past the share and of lanes past the row are zeros
  auto issue = [&](int t, int slot) {
    unsigned char* st = ring + slot * kStageBytes + lane * 16;
    const int key0 = first + t * TILE;
    const TKV* kt = kp + (long long)t * TILE * a.kss;
    const TKV* vt = vp + (long long)t * TILE * a.vss;
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int nv = 0; nv < NV; ++nv) {
        const bool ok = key0 + u * KPW < k_end && j + nv * L < chunks;
        copy16(st + (u * NV + nv) * 512,
               ok ? kt + u * KPW * a.kss + nv * L * VEC : kb, ok);
        copy16(st + ((U + u) * NV + nv) * 512,
               ok ? vt + u * KPW * a.vss + nv * L * VEC : vb, ok);
      }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_steps) issue(t, t);
    commit_copies();
  }

  float qr[GP][E];   // zero for heads past the group and pieces past the row
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int e = 0; e < E; ++e)
      qr[g][e] = g < n_g && j + e / VEC * L < chunks
                     ? __uint_as_float(q_bits[g][e])
                     : 0.0f;

  // m and the logits are in base 2 (scaled by log2(e)); with V >= L a
  // lane keeps l (and m) of its own heads over its own keys
  float m[GP], l[GP], acc[GP][E], m_own[C], l_own[C];
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    m[g] = kNegInf;
    l[g] = 0.0f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.0f;
  }
#pragma unroll
  for (int k = 0; k < C; ++k) {
    m_own[k] = kNegInf;
    l_own[k] = 0.0f;
  }

  // n_steps is the same for every lane of a warp, so the shuffles below
  // always have the whole warp
  for (int t = 0; t < n_steps; ++t) {
    if (t + kStages - 1 < n_steps)
      issue(t + kStages - 1, (t + kStages - 1) % kStages);
    commit_copies();
    wait_copies<kStages - 1>();
    const unsigned char* st = ring + (t % kStages) * kStageBytes + lane * 16;
    const int key0 = first + t * TILE;
    float s[U][GP];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[E];
#pragma unroll
      for (int nv = 0; nv < NV; ++nv)
        Vec<TKV>::unpack(
            *reinterpret_cast<const uint4*>(st + (u * NV + nv) * 512),
            kf + nv * VEC);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float dot = 0.0f;
#pragma unroll
        for (int e = 0; e < E; ++e) dot = fmaf(qr[g][e], kf[e], dot);
        s[u][g] = dot;
      }
    }
    if constexpr (V >= L) {
      // Reduce-scatter the U x GP dots over the L lanes of a key: lane j
      // ends with the sums of values C j .. C j + C - 1 (value u GP + g),
      // that is key u = j / Q and heads (j % Q) C + k. The softmax runs on
      // those alone; p goes back to every lane for P.V.
      float val[V];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < GP; ++g) val[u * GP + g] = s[u][g];
      reduce_scatter<V, L / 2>(val, lane);
      const bool valid = key0 + j / Q * KPW < k_end;
      float p[C], mv[C];
#pragma unroll
      for (int k = 0; k < C; ++k) {
        val[k] *= a.scale_log2;
        mv[k] = valid ? val[k] : kNegInf;
        // the step's max of the head over the keys (lanes j + Q u)
#pragma unroll
        for (int off = Q; off < Q * U; off <<= 1)
          mv[k] = fmaxf(mv[k], __shfl_xor_sync(kFull, mv[k], off));
        const float mn = fmaxf(m_own[k], mv[k]);
        l_own[k] *= exp2_approx(m_own[k] - mn);
        m_own[k] = mn;
        p[k] = valid ? exp2_approx(val[k] - mn) : 0.0f;
        l_own[k] += p[k];
      }
      // every head's max to every lane of the key, and acc rescaled where
      // one moved (elsewhere corr is exactly 1, so skipping it changes no
      // bit)
      const int group_lane0 = lane & ~(L - 1);
      float mn[GP];
      bool moved = false;
#pragma unroll
      for (int q = 0; q < Q; ++q)
#pragma unroll
        for (int k = 0; k < C; ++k) {
          mn[q * C + k] = __shfl_sync(kFull, m_own[k], group_lane0 + q);
          moved |= mn[q * C + k] > m[q * C + k];
        }
      if (__any_sync(kFull, moved)) {
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          const float corr = exp2_approx(m[g] - mn[g]);
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] *= corr;
        }
      }
#pragma unroll
      for (int g = 0; g < GP; ++g) m[g] = mn[g];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int q = 0; q < Q; ++q)
#pragma unroll
          for (int k = 0; k < C; ++k)
            s[u][q * C + k] =
                __shfl_sync(kFull, p[k], group_lane0 + u * Q + q);
    } else {
      // the dots of each key, summed over its L lanes
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int g = 0; g < GP; ++g)
            s[u][g] += __shfl_xor_sync(kFull, s[u][g], off);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          s[u][g] *= a.scale_log2;
          if (key0 + u * KPW < k_end) mx = fmaxf(mx, s[u][g]);
        }
        // rescale only when some lane's max moved: elsewhere corr is
        // exactly 1, so skipping it changes no bit
        if (__any_sync(kFull, mx > m[g])) {
          const float corr = exp2_approx(m[g] - mx);
          l[g] *= corr;
#pragma unroll
          for (int e = 0; e < E; ++e) acc[g][e] *= corr;
        }
        m[g] = mx;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          s[u][g] = key0 + u * KPW < k_end ? exp2_approx(s[u][g] - mx)
                                           : 0.0f;   // now p
          l[g] += s[u][g];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[E];
#pragma unroll
      for (int nv = 0; nv < NV; ++nv)
        Vec<TKV>::unpack(
            *reinterpret_cast<const uint4*>(st + ((U + u) * NV + nv) * 512),
            vf + nv * VEC);
#pragma unroll
      for (int g = 0; g < GP; ++g)
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[g][e] = fmaf(s[u][g], vf[e], acc[g][e]);
    }
  }

  if constexpr (V >= L) {
    // l of each head: its lanes' sums over the keys, then to every lane
    const int group_lane0 = lane & ~(L - 1);
#pragma unroll
    for (int k = 0; k < C; ++k) {
#pragma unroll
      for (int off = Q; off < Q * U; off <<= 1)
        l_own[k] += __shfl_xor_sync(kFull, l_own[k], off);
#pragma unroll
      for (int q = 0; q < Q; ++q)
        l[q * C + k] = __shfl_sync(kFull, l_own[k], group_lane0 + q);
    }
  }

  // each lane group's state in shared memory
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int nv = 0; nv < NV; ++nv) {
      const int c = j + nv * L;
      if (c < chunks)
#pragma unroll
        for (int i = 0; i < VEC; i += 4)
          *reinterpret_cast<float4*>(w_acc + (state * GP + g) * dh +
                                     c * VEC + i) =
              make_float4(acc[g][nv * VEC + i], acc[g][nv * VEC + i + 1],
                          acc[g][nv * VEC + i + 2], acc[g][nv * VEC + i + 3]);
    }
  if (j == 0)
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      w_m[state * GP + g] = m[g];
      w_l[state * GP + g] = l[g];
    }
  __syncthreads();
  cluster_wait();   // every CTA of the cluster runs: it may be stored to

  // the lane groups of the CTA merged in order, four elements a thread, and
  // sent to the rank that owns them (slices are whole float4s)
  const int slice = out_slice(n_g, dh);
  for (int e = 4 * threadIdx.x; e < n_g * dh; e += 4 * kThreads) {
    const int g = e / dh;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < S; ++w) mx = fmaxf(mx, w_m[w * GP + g]);
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float lsum = 0.0f;
#pragma unroll
    for (int w = 0; w < S; ++w) {
      const float c = exp2_approx(w_m[w * GP + g] - mx);
      const float4 x = *reinterpret_cast<const float4*>(
          w_acc + (w * GP + g) * dh + e % dh);
      sum.x += x.x * c;
      sum.y += x.y * c;
      sum.z += x.z * c;
      sum.w += x.w * c;
      lsum += w_l[w * GP + g] * c;
    }
    *reinterpret_cast<float4*>(cluster.map_shared_rank(r_acc, e / slice) +
                               rank * slice + e % slice) = sum;
    if (e % dh == 0)   // (m, l) of head g to every rank that owns some of it
      for (int r = g * dh / slice; r <= ((g + 1) * dh - 1) / slice; ++r) {
        cluster.map_shared_rank(r_m, r)[rank * GP + g] = mx;
        cluster.map_shared_rank(r_l, r)[rank * GP + g] = lsum;
      }
  }
  cluster.sync();   // what the ranks sent has landed

  // this rank's slice of the outputs: the splits in rank order
  float* out = a.out + ((long long)b * a.n_heads + h0) * dh;
  for (int i = threadIdx.x; i < slice && rank * slice + i < n_g * dh;
       i += kThreads) {
    const int e = rank * slice + i, g = e / dh;
    float mx = kNegInf;
#pragma unroll
    for (int r = 0; r < kSplits; ++r) mx = fmaxf(mx, r_m[r * GP + g]);
    float sum = 0.0f, lsum = 0.0f;
#pragma unroll
    for (int r = 0; r < kSplits; ++r) {
      const float c = exp2_approx(r_m[r * GP + g] - mx);
      sum += r_acc[r * slice + i] * c;
      lsum += r_l[r * GP + g] * c;
    }
    out[e] = sum / fmaxf(lsum, 1e-30f);
    if (a.lse != nullptr && e % dh == 0)
      a.lse[(long long)b * a.n_heads + h0 + g] = mx * kLn2 + logf(lsum);
  }
}

// Fills `cfg` (and its one attribute, `attr`) to launch the kernel
// instance over `grid` as clusters of kSplits CTAs, having raised the
// instance's shared-memory limit where it needs more than the default.
template <typename TKV, int NV, int L, int GP>
cudaError_t cluster_config(int head_dim, dim3 grid, cudaStream_t stream,
                           cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  const size_t bytes = smem_bytes(GP, head_dim, L);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_cluster_kernel<TKV, NV, L, GP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kSplits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename TKV, int NV, int L, int GP>
int launch(const Args& a, int batch, int n_kv_heads, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<TKV, NV, L, GP>(
      a.head_dim, dim3(kSplits, n_kv_heads * ceil_div(a.group, GP), batch),
      stream, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, decode_cluster_kernel<TKV, NV, L, GP>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TKV, int NV, int L>
int launch_group(const Args& a, int batch, int n_kv_heads,
                 cudaStream_t stream) {
  if (a.group == 1) return launch<TKV, NV, L, 1>(a, batch, n_kv_heads, stream);
  if (a.group == 2) return launch<TKV, NV, L, 2>(a, batch, n_kv_heads, stream);
  return launch<TKV, NV, L, kMaxHeadsPerPass>(a, batch, n_kv_heads, stream);
}

template <typename TKV>
int launch_lanes(const Args& a, int batch, int n_kv_heads, int chunks,
                 cudaStream_t stream) {
  switch (lanes_per_key(chunks)) {
    case 8:
      return launch_group<TKV, 1, 8>(a, batch, n_kv_heads, stream);
    case 16:
      return launch_group<TKV, 1, 16>(a, batch, n_kv_heads, stream);
    default:
      return launch_group<TKV, 1, 32>(a, batch, n_kv_heads, stream);
  }
}

int dispatch(const Args& a, int batch, int n_kv_heads, int kv_dtype,
             cudaStream_t stream) {
  const int elem = kv_dtype == 1 ? 2 : 4;
  const int chunks = a.head_dim * elem / 16;
  if (a.head_dim * elem % 16 != 0 || chunks > 64 || chunks < 1)
    return (int)cudaErrorInvalidValue;
  if (kv_dtype == 1 && chunks <= 32)
    return launch_lanes<__nv_bfloat16>(a, batch, n_kv_heads, chunks, stream);
  if (kv_dtype == 0)
    return chunks > 32
               ? launch_group<float, 2, 32>(a, batch, n_kv_heads, stream)
               : launch_lanes<float>(a, batch, n_kv_heads, chunks, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Keys one CTA covers a step, for a cache of elem_bytes-byte elements;
// a split's share of the valid range is a multiple of it.
int dg_key_tile(int elem_bytes, int head_dim) {
  return key_tile(elem_bytes, head_dim);
}

// q [B, H, Dh] read through strides (qsb, qsh); k/v [B, S, KVH, Dh]
// through (.sb, .ss, .sh); the head_dim stride of all three is 1, and k/v
// have 16-byte-aligned base addresses and row strides and rows of a
// multiple of 16 bytes (the launcher checks). lengths [B] int32 on the
// device; out [B, H, Dh] float32, contiguous; lse null, or [B, H] float32,
// contiguous, for each head's log-sum-exp over its valid keys. A cluster of
// kSplits CTAs serves each (row, KV head, pass of up to 4 heads).
// q_dtype / kv_dtype: 0 float32, 1 bfloat16. Returns the launch's CUDA
// error, or cudaGetLastError() after it.
int dg_forward(const void* q, const void* k, const void* v,
               const int* lengths, float* out, float* lse, int batch, int seq,
               int n_heads, int n_kv_heads, int head_dim,
               long long qsb, long long qsh, long long ksb, long long kss,
               long long ksh, long long vsb, long long vss, long long vsh,
               float scale, int q_dtype, int kv_dtype, void* stream) {
  if (n_heads % n_kv_heads != 0) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.lengths = lengths;
  a.out = out;
  a.lse = lse;
  a.seq = seq;
  a.n_heads = n_heads;
  a.group = n_heads / n_kv_heads;
  a.head_dim = head_dim;
  a.q_bf16 = q_dtype == 1;
  a.qsb = qsb;
  a.qsh = qsh;
  a.ksb = ksb;
  a.kss = kss;
  a.ksh = ksh;
  a.vsb = vsb;
  a.vss = vss;
  a.vsh = vsh;
  a.scale_log2 = scale * kLog2e;
  return dispatch(a, batch, n_kv_heads, kv_dtype, (cudaStream_t)stream);
}

// Clusters of llama3.2-1b's instance (bf16 cache, Dh 64, 4 heads a pass)
// that the card holds at once; a call needs B * KVH * ceil(G / 4) of them.
// A negative value is minus a CUDA error.
int dg_max_active_clusters() {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<__nv_bfloat16, 1, 8, kMaxHeadsPerPass>(
      64, dim3(kSplits, 1, 1), nullptr, cfg, attr);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(
        &n, (void*)decode_cluster_kernel<__nv_bfloat16, 1, 8,
                                         kMaxHeadsPerPass>,
        &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

}  // extern "C"
