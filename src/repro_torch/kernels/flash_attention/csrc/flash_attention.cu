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
// the H100's ~295, so it is bound by operations: 0.0348 ms at the bf16
// tensor-core peak (989 TFLOP/s). The bf16 kernel keeps p in float32, as
// the TPU kernel does, by splitting each p exactly into three bf16 terms, so
// P.V is three tensor-core products where one would do: the tensor cores do
// twice the algorithmic work (Q.K^T one unit, P.V three), and the floor of
// this design is about 0.07 ms. Beside them, each logit costs an exp2 on the
// special-function units (16 a clock an SM) and about ten ALU operations
// (max, sum, the split); at Dh = 64 that is as much time as the MMAs.
//
// bf16 design (`flash_fwd_wgmma_kernel`), point by point against the
// mma.sync kernel it replaced:
//  1. Loads are asynchronous. A producer warp starts TMA copies (128-byte
//     swizzle) of whole K/V tiles into a ring of kStages stages, with a
//     full and an empty mbarrier per stage, ahead of the consumers; Q is
//     copied once. Zero fill past Sq and Sk replaces the ragged-edge
//     masking of loads. The launcher checks that the base addresses and
//     strides are 16-byte aligned, as TMA needs, and refuses anything else.
//  2. V is read as it lies in shared memory, [keys][Dh], by the P.V wgmma
//     with the transpose flag: no element-wise transpose.
//  3. Both products are warpgroup MMAs (wgmma, float32 accumulation).
//     S = Q.K^T reads Q and K from shared memory, both K-major. P.V takes
//     P from registers: S's accumulator fragments are the A operand's
//     layout, so p goes from the softmax to the tensor cores without
//     shared memory, as three exact bf16 terms hi + mid + lo: the top 16
//     bits of p, then of the remainder, then of what is left (byte
//     permutes and masks; the last remainder has at most 8 significant
//     bits). Each consumer warpgroup starts S of tile j + 1 and P.V of
//     tile j together and runs tile j + 1's softmax while P.V runs.
//  4. One CTA owns (query tile, pack of GP query heads of one KV head,
//     batch row). GP is the largest power of two that divides the group G
//     and the CTA's rows (G itself for G in {1, 2, 4, 8}); the MMA rows
//     are BQ = rows / GP positions times GP heads, row = position * GP +
//     head, so each K/V tile is copied once for all GP heads, and rows of
//     one position share one mask.
//  5. Only the tiles where a mask bites test elements: the ragged last
//     tile, tiles that reach past the causal diagonal of the CTA's first
//     query, and tiles that reach before the window of its last query.
//     Key tiles wholly masked are never loaded.
//  6. The dynamic shared-memory attribute is set once per instantiation.
//     The tensor maps are encoded on every call by cuTensorMapEncodeTiled
//     of the CUDA driver API, looked up at run time with
//     cudaGetDriverEntryPoint (no -lcuda).
// Warp roles and tiles: warpgroup 0 is the producer (setmaxnreg 24; one
// thread starts the copies); the consumers own 64 rows each. Dh = 64: three
// consumer warpgroups (192 rows, setmaxnreg 160), since the softmax is half
// the work there and more warps hide more of it; Dh = 128: two (128 rows,
// setmaxnreg 240). 64-key tiles, four stages; 91,208 / 164,936 bytes of
// shared memory. The query tiles of a causal call launch longest first (the
// tile index is reversed and varies slowest), so no long tile runs alone at
// the end.
//
// The arithmetic is the TPU kernel's, with the scale folded into exp2:
// p = exp2(s * log2(e) / sqrt(Dh) - m), m the running row maximum scaled
// alike; masked logits -1e30 with p = 0 there; output acc / max(l, 1e-30).
// Each output is summed in a fixed order (no atomics), so repeated calls
// are bitwise equal. float32 inputs, held to the float32 tolerance (2e-5),
// take the CUDA cores (`flash_fwd_f32_kernel`).

#include <cuda.h>  // CUtensorMap and its enums (types only)
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
// bf16: TMA ring, warp specialisation, wgmma (see the note at the top).
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;
constexpr int kStages = 4;
constexpr int kChunkBytes = 128;      // one swizzled row: 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Tiles {
  // consumer warpgroups of 64 rows: three at Dh = 64, where the softmax is
  // the larger share of the work, two at Dh = 128; each may hold
  // kConsumerRegs registers a thread, the producer 24
  static constexpr int kWGs = DH == 64 ? 3 : 2;
  static constexpr int kConsumerRegs = kWGs == 3 ? 160 : 240;
  static constexpr int kRows = 64 * kWGs;           // MMA rows a CTA
  static constexpr int kConsumers = kWGs * kWgThreads;
  static constexpr int kThreads = kConsumers + kWgThreads;
  static constexpr int kBK = 64;                    // keys a tile
  static constexpr int kChunks = DH / 64;           // 64-column chunks
  static constexpr int kQBytes = kRows * DH * 2;
  static constexpr int kKVBytes = kBK * DH * 2;     // one K or one V tile
  static constexpr int kStageBytes = 2 * kKVBytes;
  // 1024 bytes to align the ring (128-byte swizzle atoms), the tiles, and
  // 2 * kStages + 1 mbarriers
  static constexpr int kSmem =
      1024 + kQBytes + kStages * kStageBytes + 8 * (2 * kStages + 1);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of the given parity has completed; a pipeline that
// waits some seconds is broken, and traps (a launch error) instead of hanging
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1LL << 34)) {
      __trap();
    }
  }
}

// one box of a 4-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups are pending (groups complete in
// order)
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of a register that an
// asynchronous wgmma owns across the wait
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][3][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][t][e])::"memory");
}

// D[64 x N] (+)= A[64 x 16] . B[16 x N], float32 accumulators in the wgmma
// fragment layout: d[4n + 2i + j] is row 16 * warp + lane / 4 + 8i, column
// 8n + 2 (lane % 4) + j. _ss: A and B K-major in shared memory (scale_d 0
// overwrites D). _rs: A from registers (the mma.m16n8k16 A fragment of
// each warp's 16 rows), B MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
    uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32],
    const uint32_t (&a)[4],
    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64],
    const uint32_t (&a)[4],
    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// (x, y) = hi + mid + lo exactly, each a bf16 pair (x in the low half):
// keep the top 16 bits of the float32 (a bf16, truncated), take the
// remainder (exact in float32), repeat; the second remainder has at most 8
// significant bits, so three 8-bit significands hold float32's 24. Integer
// byte permutes and masks, no conversion instructions.
__device__ __forceinline__ uint32_t top_halves(float x, float y) {
  return __byte_perm(__float_as_uint(x), __float_as_uint(y), 0x7632);
}

__device__ __forceinline__ float drop_top(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffff0000u);
}

__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  hi = top_halves(x, y);
  const float rx = drop_top(x), ry = drop_top(y);
  mid = top_halves(rx, ry);
  lo = top_halves(drop_top(rx), drop_top(ry));
}

// a consumer thread's two rows: query positions, running max (raw logits)
// and sum, and its column offset in an 8-column block
struct Rows {
  int qpos[2];
  float m[2], l[2];
  int c2;
};

// S = Q K^T for one warpgroup: 64 rows x kBK keys, Dh / 16 steps of 16;
// Q and K chunks are [rows][64] swizzled, a step is 32 bytes into a chunk
template <int DH>
__device__ __forceinline__ void mma_qk(float (&s)[Tiles<DH>::kBK / 2],
                                         uint32_t q_rows, uint32_t k_tile) {
  constexpr int kBK = Tiles<DH>::kBK;
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint32_t q = q_rows + (kk / 4) * Tiles<DH>::kRows * kChunkBytes;
    const uint32_t k = k_tile + (kk / 4) * kBK * kChunkBytes;
    wgmma_ss(s, sw128_desc(q + off, 16, 1024), sw128_desc(k + off, 16, 1024),
             kk > 0);
  }
}

// O += P V: 16 keys a step, p's three exact bf16 terms smallest first; V
// is [keys][64] per chunk as TMA wrote it, read MN-major (transposed):
// 8 keys a 1024-byte swizzle atom, chunks kBK * 128 bytes apart
template <int DH>
__device__ __forceinline__ void mma_pv(
    float (&oacc)[DH / 2], const uint32_t (&pa)[Tiles<DH>::kBK / 16][3][4],
    uint32_t v_tile) {
  constexpr int kBK = Tiles<DH>::kBK;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t dv =
        sw128_desc(v_tile + kk * 16 * kChunkBytes, kBK * kChunkBytes, 1024);
    wgmma_rs(oacc, pa[kk][2], dv);
    wgmma_rs(oacc, pa[kk][1], dv);
    wgmma_rs(oacc, pa[kk][0], dv);
  }
}

// online softmax of one tile in base 2, p left in s: element e is row
// qpos[(e >> 1) & 1], key k0 + 8 (e >> 2) + c2 + (e & 1), and a row lives
// on the 4 lanes of a quad. Updates m and l; corr rescales the output.
template <int kBK>
__device__ __forceinline__ void softmax_tile(float (&s)[kBK / 2], Rows& rows,
                                             int k0, bool masked, int sk,
                                             int causal, int window,
                                             float scale_log2,
                                             float (&corr)[2]) {
  if (masked) {
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e) {
      const int i = (e >> 1) & 1;
      const int kpos = k0 + 8 * (e >> 2) + rows.c2 + (e & 1);
      bool ok = kpos < sk;
      if (causal) ok = ok && kpos <= rows.qpos[i];
      if (window > 0) ok = ok && kpos > rows.qpos[i] - window;
      s[e] = ok ? s[e] : kNegInf;
    }
  }
  float row_max[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int e = 0; e < kBK / 2; ++e)
    row_max[(e >> 1) & 1] = fmaxf(row_max[(e >> 1) & 1], s[e]);
  float m_scaled[2], row_sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      row_max[i] = fmaxf(row_max[i], __shfl_xor_sync(kFull, row_max[i], off));
    const float m_new = fmaxf(rows.m[i], row_max[i]);
    corr[i] = exp2f((rows.m[i] - m_new) * scale_log2);
    rows.m[i] = m_new;
    m_scaled[i] = m_new * scale_log2;
  }
  if (masked) {
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e) {
      // a masked logit is exactly kNegInf: p = 0 there, as in the TPU
      // kernel's where(mask, exp(s - m_new), 0)
      const int i = (e >> 1) & 1;
      s[e] = s[e] == kNegInf ? 0.0f
                             : exp2f(fmaf(s[e], scale_log2, -m_scaled[i]));
    }
  } else {
#pragma unroll
    for (int e = 0; e < kBK / 2; ++e)
      s[e] = exp2f(fmaf(s[e], scale_log2, -m_scaled[(e >> 1) & 1]));
  }
#pragma unroll
  for (int e = 0; e < kBK / 2; ++e) row_sum[(e >> 1) & 1] += s[e];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      row_sum[i] += __shfl_xor_sync(kFull, row_sum[i], off);
    rows.l[i] = rows.l[i] * corr[i] + row_sum[i];
  }
}

// p into the A fragments of P V: k-step kk takes accumulator blocks 2kk and
// 2kk + 1 (registers 8kk .. 8kk + 7), as pairs, each split in three
template <int kBK>
__device__ __forceinline__ void split_tile(const float (&s)[kBK / 2],
                                           uint32_t (&pa)[kBK / 16][3][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split3(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], pa[kk][0][r],
             pa[kk][1][r], pa[kk][2][r]);
}

template <int DH>
__global__ void __launch_bounds__(Tiles<DH>::kThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ o, int sq, int sk,
                       int n_heads, int group, int pack, int n_packs,
                       int n_qtiles, int causal, int window,
                       float scale_log2) {
  using T = Tiles<DH>;
  constexpr int kBK = T::kBK;
  extern __shared__ uint8_t smem_raw[];
  constexpr int kRows = T::kRows;
  // Q chunk c at sQ + c * kRows * 128; stage st: K chunk c at
  // sK0 + st * kStageBytes + c * kBK * 128, V kKVBytes after its K
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sK0 = sQ + T::kQBytes;
  const uint32_t bars = sK0 + kStages * T::kStageBytes;
  const uint32_t q_bar = bars + 16 * kStages;
  auto full_bar = [&](int st) { return bars + 8 * st; };
  auto empty_bar = [&](int st) { return bars + 8 * (kStages + st); };

  // longest query tiles first: the tile index varies slowest, reversed
  const int per_tile = gridDim.x / n_qtiles;
  const int qt = n_qtiles - 1 - (int)(blockIdx.x / per_tile);
  const int rest = blockIdx.x % per_tile;
  const int b = rest / n_packs;
  const int h0 = (rest % n_packs) * pack;
  const int kvh = h0 / group;
  const int bq = kRows / pack;          // positions a CTA
  const int q0 = qt * bq;

  // key tiles some query of this tile can see
  const int q_last = min(q0 + bq, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kt_begin = k_begin / kBK;
  const int kt_end = (k_end + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_bar(st), 1);
      mbar_init(empty_bar(st), T::kConsumers / 32);
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {
    // producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, T::kQBytes);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c)
        tma_load_4d(sQ + c * kRows * kChunkBytes, &qmap, q_bar, c * 64, h0,
                    q0, b);
      int st = 0;
      uint32_t phase = 0;
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        mbar_wait(empty_bar(st), phase ^ 1);
        const uint32_t bar = full_bar(st);
        const uint32_t k_tile = sK0 + st * T::kStageBytes;
        mbar_expect_tx(bar, T::kStageBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c) {
          const uint32_t off = c * kBK * kChunkBytes;
          tma_load_4d(k_tile + off, &kmap, bar, c * 64, kvh, kt * kBK, b);
          tma_load_4d(k_tile + T::kKVBytes + off, &vmap, bar, c * 64, kvh,
                      kt * kBK, b);
        }
        if (++st == kStages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // consumer warpgroups: 64 rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                     T::kConsumerRegs)
                 : "memory");
    const int t = threadIdx.x - kWgThreads;
    const int cw = t / kWgThreads;
    const int lane = t % 32;
    const int row0 = cw * 64 + (t % kWgThreads) / 32 * 16 + lane / 4;
    const int shift = __ffs(pack) - 1;
    Rows rows;
    rows.c2 = 2 * (lane % 4);
    int head[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + 8 * i;       // row = position * pack + head
      rows.qpos[i] = q0 + (r >> shift);
      head[i] = h0 + (r & (pack - 1));
      rows.m[i] = kNegInf;
      rows.l[i] = 0.0f;
    }
    float oacc[DH / 2];
#pragma unroll
    for (int e = 0; e < DH / 2; ++e) oacc[e] = 0.0f;
    const uint32_t q_rows = sQ + cw * 64 * kChunkBytes;
    auto k_tile = [&](int st) { return sK0 + st * T::kStageBytes; };
    // a mask bites: the ragged last tile, a tile reaching past the first
    // query's diagonal, a tile reaching before the last query's window
    auto masked = [&](int k0) {
      return k0 + kBK > sk || (causal && k0 + kBK - 1 > q0) ||
             (window > 0 && k0 <= q_last - window);
    };

    mbar_wait(q_bar, 0);
    if (kt_begin < kt_end) {
      // S and p of tile j are computed while P.V of tile j - 1 runs
      float s[kBK / 2];
      uint32_t pa[kBK / 16][3][4];
      float corr[2];
      int st = 0;
      uint32_t phase = 0;
      mbar_wait(full_bar(st), phase);
      wgmma_fence();
      mma_qk<DH>(s, q_rows, k_tile(st));
      wgmma_commit();
      wgmma_wait<0>();
      hold(s);
      softmax_tile<kBK>(s, rows, kt_begin * kBK, masked(kt_begin * kBK), sk,
                        causal, window, scale_log2, corr);
      split_tile<kBK>(s, pa);
      for (int kt = kt_begin + 1; kt < kt_end; ++kt) {
        const int prev = st;
        if (++st == kStages) {
          st = 0;
          phase ^= 1;
        }
        mbar_wait(full_bar(st), phase);
        wgmma_fence();
        mma_qk<DH>(s, q_rows, k_tile(st));
        wgmma_commit();
        mma_pv<DH>(oacc, pa, k_tile(prev) + T::kKVBytes);
        wgmma_commit();
        wgmma_wait<1>();                // S of tile kt is in
        hold(s);
        softmax_tile<kBK>(s, rows, kt * kBK, masked(kt * kBK), sk, causal,
                          window, scale_log2, corr);
        wgmma_wait<0>();                // P.V of tile kt - 1 is in
        hold(oacc);
        hold(pa);
        if (lane == 0) mbar_arrive(empty_bar(prev));
#pragma unroll
        for (int e = 0; e < DH / 2; ++e) oacc[e] *= corr[(e >> 1) & 1];
        split_tile<kBK>(s, pa);
      }
      wgmma_fence();
      mma_pv<DH>(oacc, pa, k_tile(st) + T::kKVBytes);
      wgmma_commit();
      wgmma_wait<0>();
      hold(oacc);
      hold(pa);
      if (lane == 0) mbar_arrive(empty_bar(st));
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows.qpos[i] >= sq) continue;
      const float denom = fmaxf(rows.l[i], 1e-30f);
      __nv_bfloat16* row = o +
                           ((long long)b * sq + rows.qpos[i]) * n_heads * DH +
                           (long long)head[i] * DH;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * n + rows.c2) =
            __floats2bfloat162_rn(oacc[4 * n + 2 * i] / denom,
                                  oacc[4 * n + 2 * i + 1] / denom);
    }
  }
}

// cuTensorMapEncodeTiled of the CUDA driver API, looked up at run time
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

constexpr int kNoEncoder = 999;       // error codes beside CUDA's own
constexpr int kEncodeFailed = 1000;   // + the CUresult

// a 4-D bf16 tensor map over (Dh, heads, positions, batch) of a tensor with
// element strides s, boxes of 64 x box_heads x box_len x 1, 128-byte
// swizzle, zero fill out of bounds; 0 or an error code
int encode_map(CUtensorMap* map, const void* base, int dh, int heads, int len,
               int batch, Strides s, int box_heads, int box_len) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return kNoEncoder;
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long extent[3] = {heads, len, batch};
  const long long stride[3] = {s.h, s.s, s.b};
  cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads, (cuuint64_t)len,
                        (cuuint64_t)batch};
  cuuint64_t bytes[3];
  for (int i = 0; i < 3; ++i) {
    // a dimension of extent 1 is never stepped: any aligned stride will do
    const long long b = extent[i] == 1 ? 2LL * dh : 2LL * stride[i];
    if (b < 0 || b % 16 != 0 || b >= (1LL << 40))
      return (int)cudaErrorInvalidValue;
    bytes[i] = (cuuint64_t)b;
  }
  cuuint32_t box[4] = {64, (cuuint32_t)box_heads, (cuuint32_t)box_len, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 int batch, int sq, int sk, int n_heads, int n_kv_heads,
                 Strides qs, Strides ks, Strides vs, int causal, int window,
                 float scale, cudaStream_t stream) {
  using T = Tiles<DH>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int group = n_heads / n_kv_heads;
  // the largest power of two that divides both G and the rows of a CTA
  const int pack = min(group & -group, T::kRows & -T::kRows);
  const int bq = T::kRows / pack;
  CUtensorMap qmap, kmap, vmap;
  int err = encode_map(&qmap, q, DH, n_heads, sq, batch, qs, pack, bq);
  if (err == 0)
    err = encode_map(&kmap, k, DH, n_kv_heads, sk, batch, ks, 1, T::kBK);
  if (err == 0)
    err = encode_map(&vmap, v, DH, n_kv_heads, sk, batch, vs, 1, T::kBK);
  if (err != 0) return err;
  const long long n_qtiles = (sq + bq - 1) / bq;
  const long long blocks = n_qtiles * (n_heads / pack) * batch;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_fwd_wgmma_kernel<DH><<<(unsigned)blocks, T::kThreads, T::kSmem,
                               stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), sq, sk, n_heads,
      group, pack, n_heads / pack, (int)n_qtiles, causal, window,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               int batch, int sq, int sk, int n_heads, int group, Strides qs,
               Strides ks, Strides vs, int causal, int window, float scale,
               cudaStream_t stream) {
  constexpr int bytes = smem_floats<DH>() * (int)sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return (int)attr;
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
// q's type. dtype: 0 float32, 1 bfloat16; bf16 needs 16-byte-aligned base
// addresses and strides (TMA). Returns cudaGetLastError() after the launch,
// a CUDA error code if the inputs are refused, 999 if
// cuTensorMapEncodeTiled cannot be looked up, or 1000 + its CUresult if it
// failed.
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
    return launch_wgmma<64>(q, k, v, o, batch, sq, sk, n_heads, n_kv_heads,
                            qs, ks, vs, causal, window, scale, st);
  if (dtype == 1 && head_dim == 128)
    return launch_wgmma<128>(q, k, v, o, batch, sq, sk, n_heads, n_kv_heads,
                             qs, ks, vs, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
