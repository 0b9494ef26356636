// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// `_kernel` (wrapper `flash_attention_bhsd`, entry `ops.flash_attention`):
// causal or sliding-window grouped-query attention over a whole sequence,
// with the online softmax in float32 and fully masked key tiles skipped.
//
// What bounds it on this card. At llama3.2-1b's prefill shape (B = 2,
// S = 2,048, H = 32 over KVH = 8, Dh = 64, causal, bf16) the call does
// 34.4 GFLOP over 42 MB of q/k/v/o: about 800 operations a byte, well above
// the H100's ~295, so it is bound by operations: ~35 us at the bf16
// tensor-core peak.
//
// What the design does about it. One CTA owns one (batch, head, 64-query
// tile) and loops over 64-key tiles inside the CTA, in place of the TPU's
// sequential key grid axis; the running (m, l, acc) state stays in float32
// registers. Key tiles wholly above the causal diagonal or wholly before the
// window are never loaded. q, k and v are read in their [B, S, H, Dh] layout
// through strides, and the ragged Sq / Sk edges are masked here, so the
// launcher neither transposes nor pads. bf16 inputs take the tensor cores
// (mma.sync, float32 accumulation) for both products, with p split exactly
// into three bf16 terms so that it keeps its float32 value, as the TPU
// kernel keeps it; float32 inputs, held to the float32 tolerance (2e-5),
// take the CUDA cores. The arithmetic is the TPU kernel's: scale by
// 1/sqrt(Dh) after the dot, masked logits -1e30, p = mask ? exp(s - m_new)
// : 0, output acc / max(l, 1e-30).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // queries per CTA
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16 threads
constexpr int kPad = 4;          // row padding in floats (keeps float4 rows)
constexpr int kLdQ = kBQ + kPad;  // Qt[d][q] and Pt[k][q]
constexpr int kLdK = kBK + kPad;  // Kt[d][k]
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  long long b, s, h;  // in elements; the head_dim stride is 1
};

// ---------------------------------------------------------------------------
// float32: every product on the CUDA cores. One CTA of 256 threads owns 64
// queries; each thread owns a 4 x 4 tile of the 64 x 64 logits and a
// 4 x (Dh / 16) tile of the output, so each product step reads two float4s
// from shared memory for 16 FMAs. q and k tiles are staged transposed
// ([Dh][64]), v and p row-major, each row padded by 4 floats.
// ---------------------------------------------------------------------------

template <int DH>
constexpr int smem_floats() {
  return DH * kLdQ + DH * kLdK + kBK * (DH + kPad) + kBK * kLdQ;
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_f32_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int sq, int sk, int n_heads, int group, Strides qs,
                     Strides ks, Strides vs, int causal, int window,
                     float scale) {
  static_assert(DH % 64 == 0, "head_dim must be a multiple of 64");
  constexpr int kLdV = DH + kPad;
  constexpr int kCG = DH / 64;     // 64-column groups of the output tile
  constexpr int kAcc = 4 * kCG;    // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);
  float* Kt = Qt + DH * kLdQ;
  float* Vs = Kt + DH * kLdK;
  float* Pt = Vs + kBK * kLdV;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;

  for (int e = tid; e < kBQ * DH; e += kThreads) {
    const int r = e / DH, d = e % DH, pos = q0 + r;
    Qt[d * kLdQ + r] = pos < sq ? qb[pos * qs.s + d] : 0.0f;
  }

  // key tiles some query of this tile can see
  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_begin / kBK;
  const int kt_end = (k_end + kBK - 1) / kBK;

  float m[4], l[4], acc[4][kAcc];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kAcc; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * DH; e += kThreads) {
      const int c = e / DH, d = e % DH, pos = k0 + c;
      const bool in = pos < sk;
      Kt[d * kLdK + c] = in ? kb[pos * ks.s + d] : 0.0f;
      Vs[c * kLdV + d] = in ? vb[pos * vs.s + d] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qt[d * kLdQ + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Kt[d * kLdK + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    // online softmax; a row's 64 logits live on the 16 lanes sharing ty
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      bool mask[4];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        bool ok = kpos < sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        mask[j] = ok;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(kFull, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      float row_sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = mask[j] ? expf(s[i][j] - m_new) : 0.0f;
        s[i][j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(kFull, row_sum, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kAcc; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * kLdQ + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&Pt[kk * kLdQ + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int g = 0; g < kCG; ++g) {
        const float4 w =
            *reinterpret_cast<const float4*>(&Vs[kk * kLdV + g * 64 + tx * 4]);
        const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][g * 4 + c] = fmaf(av[i], wv[c], acc[i][g * 4 + c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int pos = q0 + ty * 4 + i;
    if (pos >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* row =
        o + ((long long)b * sq + pos) * n_heads * DH + (long long)h * DH;
#pragma unroll
    for (int g = 0; g < kCG; ++g)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        row[g * 64 + tx * 4 + c] = acc[i][g * 4 + c] / denom;
  }
}

// ---------------------------------------------------------------------------
// bf16: the products on the tensor cores (mma.sync m16n8k16, float32
// accumulation). Four warps of a CTA own 16 query rows each. S = Q K^T
// stays in the MMA's float32 accumulator fragments, which are also the
// A-operand layout of P . V, so p never leaves the registers. To keep p in
// float32, as the TPU kernel does, each p is split exactly into three bf16
// terms (p = p1 + p2 + p3: 3 x 8 significant bits) and P . V is three MMAs;
// v is bf16 already, so every product is exact and only the float32
// accumulation order differs.
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;  // 16 query rows a warp
constexpr int kPadH = 8;   // bf16 row padding: fragment loads hit 32 banks

template <int DH>
constexpr int mma_smem_bytes() {
  return (int)sizeof(__nv_bfloat16) *
         (kBQ * (DH + kPadH) + kBK * (DH + kPadH) + DH * (kBK + kPadH));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x, y) = hi + mid + lo exactly, each a bf16 pair (x in the low half)
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  hi = as_u32(h);
  mid = as_u32(m);
  lo = as_u32(__floats2bfloat162_rn(rx - mf.x, ry - mf.y));
}

template <int DH>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int sq, int sk,
                     int n_heads, int group, Strides qs, Strides ks,
                     Strides vs, int causal, int window, float scale) {
  constexpr int kLd = DH + kPadH;       // Qs[q][d], Ks[k][d]
  constexpr int kLdVt = kBK + kPadH;    // Vt[d][k]
  constexpr int kKSteps = DH / 16;      // 16-deep steps of Q K^T
  constexpr int kNT = kBK / 8;          // 8-key tiles of S
  constexpr int kDT = DH / 8;           // 8-column tiles of the output
  extern __shared__ float4 smem4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* Ks = Qs + kBQ * kLd;
  __nv_bfloat16* Vt = Ks + kBK * kLd;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;   // MMA group and thread in group
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / group;
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + kvh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kvh * vs.h;

  for (int e = tid; e < kBQ * DH; e += kMmaThreads) {
    const int r = e / DH, d = e % DH, pos = q0 + r;
    Qs[r * kLd + d] = pos < sq ? qb[pos * qs.s + d] : zero;
  }
  __syncthreads();
  const int r0 = warp * 16 + g;          // this thread's rows r0, r0 + 8
  uint32_t qa[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const int c = kk * 16 + t * 2;
    qa[kk][0] = ld_pair(&Qs[r0 * kLd + c]);
    qa[kk][1] = ld_pair(&Qs[(r0 + 8) * kLd + c]);
    qa[kk][2] = ld_pair(&Qs[r0 * kLd + c + 8]);
    qa[kk][3] = ld_pair(&Qs[(r0 + 8) * kLd + c + 8]);
  }

  const int q_last = min(q0 + kBQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_begin / kBK;
  const int kt_end = (k_end + kBK - 1) / kBK;

  const int qpos[2] = {q0 + r0, q0 + r0 + 8};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float oacc[kDT][4];
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dt][e] = 0.0f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kBK * DH; e += kMmaThreads) {
      const int c = e / DH, d = e % DH, pos = k0 + c;
      const bool in = pos < sk;
      Ks[c * kLd + d] = in ? kb[pos * ks.s + d] : zero;
      Vt[d * kLdVt + c] = in ? vb[pos * vs.s + d] : zero;
    }
    __syncthreads();

    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
      const __nv_bfloat16* krow = &Ks[(nt * 8 + g) * kLd + t * 2];
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        mma_bf16(s[nt], qa[kk], ld_pair(krow + kk * 16),
                 ld_pair(krow + kk * 16 + 8));
    }

    // online softmax; element e of tile nt is row qpos[e / 2], key
    // k0 + nt * 8 + t * 2 + e % 2, and a row lives on the 4 lanes of a group
    float row_max[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + nt * 8 + t * 2 + (e & 1);
        const int qp = qpos[e >> 1];
        bool ok = kpos < sk;
        if (causal) ok = ok && kpos <= qp;
        if (window > 0) ok = ok && kpos > qp - window;
        s[nt][e] = ok ? s[nt][e] * scale : kNegInf;
        row_max[e >> 1] = fmaxf(row_max[e >> 1], s[nt][e]);
      }
    float corr[2], m_new[2], row_sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        row_max[i] = fmaxf(row_max[i], __shfl_xor_sync(kFull, row_max[i], off));
      m_new[i] = fmaxf(m[i], row_max[i]);
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked logit is exactly kNegInf: p = 0 there, as in the TPU
        // kernel's where(mask, exp(s - m_new), 0)
        const float p =
            s[nt][e] == kNegInf ? 0.0f : expf(s[nt][e] - m_new[e >> 1]);
        s[nt][e] = p;
        row_sum[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        row_sum[i] += __shfl_xor_sync(kFull, row_sum[i], off);
      corr[i] = expf(m[i] - m_new[i]);
      l[i] = l[i] * corr[i] + row_sum[i];
      m[i] = m_new[i];
    }
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[dt][e] *= corr[e >> 1];

#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t hi[4], mid[4], lo[4];
      split3(s[2 * kk][0], s[2 * kk][1], hi[0], mid[0], lo[0]);
      split3(s[2 * kk][2], s[2 * kk][3], hi[1], mid[1], lo[1]);
      split3(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], mid[2], lo[2]);
      split3(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], mid[3], lo[3]);
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        const __nv_bfloat16* vrow = &Vt[(dt * 8 + g) * kLdVt + kk * 16 + t * 2];
        const uint32_t b0 = ld_pair(vrow), b1 = ld_pair(vrow + 8);
        mma_bf16(oacc[dt], lo, b0, b1);
        mma_bf16(oacc[dt], mid, b0, b1);
        mma_bf16(oacc[dt], hi, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qpos[i] >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* row =
        o + ((long long)b * sq + qpos[i]) * n_heads * DH + (long long)h * DH;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(row + dt * 8 + t * 2) =
          __floats2bfloat162_rn(oacc[dt][2 * i] / denom,
                                oacc[dt][2 * i + 1] / denom);
  }
}

template <int DH>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               int batch, int sq, int sk, int n_heads, int group, Strides qs,
               Strides ks, Strides vs, int causal, int window, float scale,
               cudaStream_t stream) {
  constexpr int bytes = mma_smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, n_heads, batch);
  flash_fwd_mma_kernel<DH><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      sq, sk, n_heads, group, qs, ks, vs, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               int batch, int sq, int sk, int n_heads, int group, Strides qs,
               Strides ks, Strides vs, int causal, int window, float scale,
               cudaStream_t stream) {
  constexpr int bytes = smem_floats<DH>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, n_heads, batch);
  flash_fwd_f32_kernel<DH><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), sq, sk, n_heads,
      group, qs, ks, vs, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, Sq, H, Dh], k/v [B, Sk, KVH, Dh] read through the given element
// strides (the head_dim stride is 1); o is a contiguous [B, Sq, H, Dh] of
// q's type. dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError() after
// the launch.
int fa_forward(const void* q, const void* k, const void* v, void* o,
               int batch, int sq, int sk, int n_heads, int n_kv_heads,
               int head_dim, long long qsb, long long qss, long long qsh,
               long long ksb, long long kss, long long ksh, long long vsb,
               long long vss, long long vsh, int causal, int window,
               float scale, int dtype, void* stream) {
  const Strides qs{qsb, qss, qsh}, ks{ksb, kss, ksh}, vs{vsb, vss, vsh};
  const int group = n_heads / n_kv_heads;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0 && head_dim == 64)
    return launch_f32<64>(q, k, v, o, batch, sq, sk, n_heads, group, qs, ks,
                          vs, causal, window, scale, st);
  if (dtype == 0 && head_dim == 128)
    return launch_f32<128>(q, k, v, o, batch, sq, sk, n_heads, group, qs, ks,
                           vs, causal, window, scale, st);
  if (dtype == 1 && head_dim == 64)
    return launch_mma<64>(q, k, v, o, batch, sq, sk, n_heads, group, qs, ks,
                          vs, causal, window, scale, st);
  if (dtype == 1 && head_dim == 128)
    return launch_mma<128>(q, k, v, o, batch, sq, sk, n_heads, group, qs, ks,
                           vs, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
