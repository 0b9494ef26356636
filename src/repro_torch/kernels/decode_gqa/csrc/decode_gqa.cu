// Single-token grouped-query decode attention for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_gqa/kernel.py
// `_kernel` (wrapper `decode_gqa_grouped`, entry `ops.decode_gqa`): one new
// query per row against a KV cache, with a valid length per row, and the
// G = H / KVH query heads that share a KV head served by one pass over it.
//
// What bounds it on this card. Each valid key and value row is read once
// and used for a handful of FMAs (G dot products of Dh), so the kernel is
// bound by bytes: at llama3.2-1b (B = 4, KVH = 8, Dh = 64, 2,048 valid keys,
// bf16 cache) it streams 16.8 MB, about 5 us at 3.35 TB/s.
//
// What the design does about it. The TPU kernel walks the key axis of one
// (batch, kv-head) pair in sequence; here B * KVH = 32 pairs would leave
// most of the 132 SMs idle, so the key axis is split across CTAs
// (flash-decoding): one CTA per (split of 64 keys, kv-head, batch row).
// A CTA reads its row's length from the device `lengths` tensor (the TPU's
// scalar prefetch), returns at once when its split holds no valid key, and
// otherwise stages only the valid K and V rows of its split in shared
// memory (coalesced reads along Dh, converted to float32), so every K/V row
// is loaded once for all G heads and bytes past the length are never read.
// It writes its split's running max, sum and unnormalised output; a second
// small kernel combines the splits of each (batch, head) in split order --
// no atomics, so the output repeats bit for bit. The cache is read in its
// [B, S, KVH, Dh] layout through strides: nothing is transposed or padded.
// The arithmetic is the TPU kernel's: scale by 1/sqrt(Dh) after the dot,
// p = exp(s - m), output acc / max(l, 1e-30); a row of length 0 gives
// zeros, as the TPU kernel does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;      // keys per split (two per lane of a warp)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCombineThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kChunk == 64, "the softmax gives each lane keys lane, lane + 32");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ int valid_length(const int* lengths, int b,
                                            int seq) {
  return min(max(lengths[b], 0), seq);
}

int smem_bytes(int group, int head_dim) {
  return (int)sizeof(float) * (kChunk * (head_dim + 1) + kChunk * head_dim +
                               group * head_dim + group * kChunk);
}

// part_ml [B, H, n_splits, 2] (max, sum), part_acc [B, H, n_splits, Dh]
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int seq, int n_heads, int group, int head_dim,
                    int n_splits, long long qsb, long long qsh, long long ksb,
                    long long kss, long long ksh, long long vsb,
                    long long vss, long long vsh, float scale) {
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = valid_length(lengths, b, seq);
  const int k0 = split * kChunk;
  if (k0 >= len) return;  // the combine stops before this split
  const int n = min(kChunk, len - k0);
  const int ldk = head_dim + 1;
  extern __shared__ float smem[];
  float* Ks = smem;                      // [kChunk][head_dim + 1]
  float* Vs = Ks + kChunk * ldk;         // [kChunk][head_dim]
  float* Qs = Vs + kChunk * head_dim;    // [group][head_dim]
  float* Ps = Qs + group * head_dim;     // [group][kChunk]

  const int tid = threadIdx.x;
  const int h0 = kvh * group;
  for (int e = tid; e < group * head_dim; e += kThreads) {
    const int g = e / head_dim, d = e % head_dim;
    Qs[e] = to_float(q[b * qsb + (h0 + g) * qsh + d]);
  }
  const TKV* kb = k + b * ksb + kvh * ksh;
  const TKV* vb = v + b * vsb + kvh * vsh;
  for (int e = tid; e < n * head_dim; e += kThreads) {
    const int c = e / head_dim, d = e % head_dim;
    const long long pos = k0 + c;
    Ks[c * ldk + d] = to_float(kb[pos * kss + d]);
    Vs[c * head_dim + d] = to_float(vb[pos * vss + d]);
  }
  __syncthreads();

  for (int e = tid; e < group * kChunk; e += kThreads) {
    const int g = e / kChunk, c = e % kChunk;
    float s = kNegInf;
    if (c < n) {
      float dot = 0.0f;
      for (int d = 0; d < head_dim; ++d)
        dot = fmaf(Qs[g * head_dim + d], Ks[c * ldk + d], dot);
      s = dot * scale;
    }
    Ps[e] = s;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  for (int g = warp; g < group; g += kWarps) {
    float* row = Ps + g * kChunk;
    const float s0 = row[lane], s1 = row[lane + 32];
    float mx = fmaxf(s0, s1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    const float p0 = lane < n ? expf(s0 - mx) : 0.0f;
    const float p1 = lane + 32 < n ? expf(s1 - mx) : 0.0f;
    row[lane] = p0;
    row[lane + 32] = p1;
    float sum = p0 + p1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    if (lane == 0) {
      float* ml = part_ml +
                  (((long long)b * n_heads + h0 + g) * n_splits + split) * 2;
      ml[0] = mx;
      ml[1] = sum;
    }
  }
  __syncthreads();

  for (int e = tid; e < group * head_dim; e += kThreads) {
    const int g = e / head_dim, d = e % head_dim;
    float acc = 0.0f;
    for (int c = 0; c < n; ++c)
      acc = fmaf(Ps[g * kChunk + c], Vs[c * head_dim + d], acc);
    part_acc[(((long long)b * n_heads + h0 + g) * n_splits + split) *
                 head_dim + d] = acc;
  }
}

// out [B, H, Dh] float32: the splits of each (batch, head) in split order
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml,
                      const int* __restrict__ lengths,
                      float* __restrict__ out, int seq, int n_heads,
                      int head_dim, int n_splits) {
  const int bh = blockIdx.x, b = bh / n_heads;
  const int len = valid_length(lengths, b, seq);
  const int ns = (len + kChunk - 1) / kChunk;
  const float* ml = part_ml + (long long)bh * n_splits * 2;
  float m = kNegInf;
  for (int s = 0; s < ns; ++s) m = fmaxf(m, ml[2 * s]);
  float l = 0.0f;
  for (int s = 0; s < ns; ++s) l += ml[2 * s + 1] * expf(ml[2 * s] - m);
  const float denom = fmaxf(l, 1e-30f);
  const float* acc = part_acc + (long long)bh * n_splits * head_dim;
  for (int d = threadIdx.x; d < head_dim; d += kCombineThreads) {
    float a = 0.0f;
    for (int s = 0; s < ns; ++s)
      a += acc[(long long)s * head_dim + d] * expf(ml[2 * s] - m);
    out[(long long)bh * head_dim + d] = a / denom;
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           float* part_acc, float* part_ml, float* out, int batch, int seq,
           int n_heads, int n_kv_heads, int head_dim, int n_splits,
           long long qsb, long long qsh, long long ksb, long long kss,
           long long ksh, long long vsb, long long vss, long long vsh,
           float scale, cudaStream_t stream) {
  const int group = n_heads / n_kv_heads;
  const int bytes = smem_bytes(group, head_dim);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<TQ, TKV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  decode_split_kernel<TQ, TKV>
      <<<dim3(n_splits, n_kv_heads, batch), kThreads, bytes, stream>>>(
          static_cast<const TQ*>(q), static_cast<const TKV*>(k),
          static_cast<const TKV*>(v), lengths, part_acc, part_ml, seq,
          n_heads, group, head_dim, n_splits, qsb, qsh, ksb, kss, ksh, vsb,
          vss, vsh, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<<<batch * n_heads, kCombineThreads, 0, stream>>>(
      part_acc, part_ml, lengths, out, seq, n_heads, head_dim, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int dg_chunk() { return kChunk; }

// Shared memory one split needs, in bytes (the launcher refuses more than
// the card gives a block).
int dg_smem_bytes(int group, int head_dim) {
  return smem_bytes(group, head_dim);
}

// q [B, H, Dh] read through strides (qsb, qsh); k/v [B, S, KVH, Dh]
// through (.sb, .ss, .sh); the head_dim stride of all three is 1.
// lengths [B] int32 on the device; part_acc [B, H, n_splits, Dh] and
// part_ml [B, H, n_splits, 2] float32 scratch; out [B, H, Dh] float32.
// q_dtype / kv_dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError()
// after the launches.
int dg_forward(const void* q, const void* k, const void* v,
               const int* lengths, float* part_acc, float* part_ml,
               float* out, int batch, int seq, int n_heads, int n_kv_heads,
               int head_dim, int n_splits, long long qsb, long long qsh,
               long long ksb, long long kss, long long ksh, long long vsb,
               long long vss, long long vsh, float scale, int q_dtype,
               int kv_dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define DG_LAUNCH(TQ, TKV)                                                  \
  return launch<TQ, TKV>(q, k, v, lengths, part_acc, part_ml, out, batch,  \
                         seq, n_heads, n_kv_heads, head_dim, n_splits, qsb, \
                         qsh, ksb, kss, ksh, vsb, vss, vsh, scale, st)
  if (q_dtype == 0 && kv_dtype == 0) DG_LAUNCH(float, float);
  if (q_dtype == 0 && kv_dtype == 1) DG_LAUNCH(float, __nv_bfloat16);
  if (q_dtype == 1 && kv_dtype == 0) DG_LAUNCH(__nv_bfloat16, float);
  if (q_dtype == 1 && kv_dtype == 1) DG_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef DG_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
