// Blocked online-softmax attention, forward pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py (body
// flash_attention_kernel, wrapper flash_attention).  It computes, for every
// (batch, q-head) and query row, the causal or full softmax attention of
// q / sqrt(D) against the rows of the head's kv-head (GQA: q-head h reads
// kv-head h / (Hq / Hkv) directly, without a repeated copy): float32
// scores, masked logits -1e30, a running max and denominator per row,
// output acc / max(l, 1e-30) rounded to the input type.
//
// Two bodies; kernels/flash_attention.py::plan picks one.
//
// * The tensor-core body (tc::flash_attention_tc_kernel): bf16, D a
//   multiple of 16 up to 160, instantiated at DP = 16, 32, 64, 128, 160
//   (the next one at or above D): the tensor maps keep the true D, so TMA
//   zero-fills columns D .. DP - 1 of q, k and v; zero columns add nothing
//   to QKᵀ and give output columns the epilogue does not store.  What
//   bounds it is the bf16 tensor-core rate: causal
//   attention needs 4·B·Hq·D·S(S+1)/2 FLOPs in two products, and this body
//   spends twice that (below).  One block per (128 q rows, batch·head), the
//   longest causal tiles first: two consumer warpgroups of 64 q rows and
//   one producer warpgroup.  The producer (24 registers after setmaxnreg)
//   has one thread issue TMA loads: the q tile once, then k and v tiles of
//   KV_ROWS = 64 rows into a ring of 3 stages, each signalled through its
//   own mbarrier and freed through an "empty" mbarrier (the producer
//   itself releases a tile for a consumer whose rows do not see it).  Each
//   consumer (240 registers) takes, per kv tile:
//     - S = Q·Kᵀ with wgmma m64n64k16 (Q and K K-major in shared memory,
//       swizzled by TMA as wgmma reads them, no transpose), float32
//       accumulation;
//     - the mask on diagonal and ragged tiles only (fully masked tiles are
//       never loaded; the masking code is a separate instantiation, so the
//       other tiles spend no instruction on it), and the online softmax in
//       registers in base 2: p = 2^(s·c − m·c), c = log2(e)/sqrt(D), one
//       FMA and one ex2 per score (within the tolerance below, by the CPU
//       emulation in tests/test_torch_flash_attention.py), each row
//       reduced across the 4 threads that share it in the fragment;
//     - the split p = p_hi + p_mid + p_lo, each term the top 8 significant
//       bits of what is left (bf16 rounded toward zero: integer masks and
//       byte permutes, no conversion instructions), so that the three
//       terms sum to p exactly;
//     - P·V as three wgmma m64nDk16 per 16 kv rows, A = one term of P from
//       registers, B = the V tile MN-major in shared memory, into a fresh
//       float32 accumulator, folded into the running output as acc·alpha +
//       pv (one FMA an element).  Accumulating P·V onto the rescaled
//       output inside the tensor cores instead fails the bf16 tolerance
//       below at 32768 tokens (on ~2000 of 67M elements, up to 2.7x; the
//       tensor cores' own float32 sums lose bits over 512 tiles;
//       tools/flash_attention_ablation.py, variant direct_accumulate).
//   One consumer's softmax runs while the other waits on its wgmmas: the
//   warp schedulers interleave the two warpgroups.  Explicit turns (FA3's
//   ping-pong over named barriers) and a software pipeline (tile j's QKᵀ
//   issued with tile j-1's P·V, the softmax under that P·V) were built,
//   measured no faster (tools/flash_attention_ablation.py) and removed.
//   Why three terms: held against the reference under chip_smoke.py's bf16
//   tolerance (float32 rtol 1e-5 / atol 1e-6 plus one bf16 ulp), an
//   emulation of P rounded to bf16 once failed on 8-12% of the elements
//   of every shape (up to 283x the tolerance); a two-term split failed at
//   the serve shape (4, 32, 8, 32, 64) on 0-7 elements per seed (up to
//   2.08x); three terms pass everywhere.  So P·V runs three tensor-core
//   passes, and the body's floor is twice the function's bound.
//   KV_ROWS = 64 keeps a consumer thread at S 32 + P terms 48 + tile and
//   running accumulators D/2 each: 144 registers at D = 64, 176 at D =
//   128, within the 240 it has (a third consumer warpgroup would leave
//   160, and spills at D = 64).  At D = 160 that count is 240, the whole
//   budget before addresses, m and l, yet ptxas fits it with no spill
//   (flash_attention.tc_resources), so P·V stays one wgmma group over
//   all 160 columns (m64n160k16).  P·V in two groups of columns, one tile
//   accumulator live at a time (96 + 64 or 128 + 32), and an
//   instantiation at 192 (64-column chunks, 20% more tensor-core work)
//   were built and measured slower (tools/flash_attention_ablation.py).
//   D = 160 is no multiple of 64, so its tiles are stored as five
//   32-column chunks (64-byte rows, TMA's and wgmma's 64-byte swizzle)
//   and every load is five TMA boxes.
//   Shared memory there: q 40 KB + 3 stages of k and v, 20 KB each.
//   The output is stored from registers, bf16 pairs.  TMA descriptors
//   are 4-D (D, S, H, B) over the tensors' own strides, so the model's
//   transposed (B, S, H, D) views are read in place; TMA zero-fills rows
//   beyond S.  They are built per launch with cuTensorMapEncodeTiled,
//   fetched through cudaGetDriverEntryPoint (no -lcuda).
//
// * The CUDA-core body (flash_attention_kernel): float32 at every D, and
//   bf16 at the D the tensor-core body does not take (8, 14, 20, 176,
//   ...), instantiated at DP = 8, 16, 32, 64, 128, 160, 256 (the next one
//   at or above D) with columns D .. DP - 1 read as zeros and never
//   stored.  It loads 4-element vectors where D and the strides are
//   multiples of 4 (`vec`) and single elements otherwise (a contiguous
//   row of 14 bf16 values is 28 bytes).  Float32 stays here: its
//   rtol 1e-5 needs float32 products.  One block of 256 threads per (q
//   tile of BQ = 64 rows, batch·head), the longest causal tiles first,
//   walking the kv tiles of BKV = 64 rows that its rows can see, with q
//   (scaled, transposed), k (transposed) and v staged in shared memory.
//   Thread (rg, cg) = (tid / 16, tid % 16) owns rows 4 rg .. 4 rg + 3: it
//   computes their scores against columns 4 cg .. 4 cg + 3 of the kv tile
//   (a 4 x 4 register tile over D), reduces each row's max and sum across
//   the 16 threads that share it with warp shuffles, writes p to shared
//   memory (transposed), and accumulates output columns cg·OC .. cg·OC +
//   OC - 1 (OC = D / 16, or one column for D < 16) of its rows in
//   registers.  Everything is float32 on the CUDA cores: what bounds it is
//   the float32 FMA rate, at most ~1/15 of the bf16 tensor-core rate.
//
// Plain C interface (ctypes); pointers, int64 element strides for (batch,
// head, position) with the last dimension contiguous, and for the
// tensor-core body the TMA dims, byte strides and boxes of the plan.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define BQ 64
#define BKV 64
#define THREADS 256
#define PAD 4  // row padding of the transposed tiles (keeps float4 alignment)
#define NEG_INF (-1e30f)

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Columns 4g .. 4g + 3 of a row: a vector load, or (vec false) single
// elements; columns at or past D are zeros.
template <typename T>
__device__ __forceinline__ float4 load_cols(const T* row, int g, int D,
                                            bool vec) {
  if (vec) return 4 * g < D ? load4(row + 4 * g) : make_float4(0.f, 0.f, 0.f, 0.f);
  float x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = 4 * g + j < D ? to_float(row[4 * g + j]) : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

// rows x DP of `src` (rows from `row0`, `n_rows` valid, D columns, scaled
// by `scale`) into dst[d][row] with row stride ROWS + PAD: consecutive
// threads take consecutive rows, so the transposed stores hit consecutive
// banks
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void stage_transposed(float* dst, const T* src,
                                                 long long stride, int row0,
                                                 int n_rows, int D, bool vec,
                                                 float scale) {
  for (int idx = threadIdx.x; idx < ROWS * (DP / 4); idx += THREADS) {
    const int r = idx % ROWS, g = idx / ROWS;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) x = load_cols(src + (row0 + r) * stride, g, D, vec);
    dst[(4 * g + 0) * (ROWS + PAD) + r] = x.x * scale;
    dst[(4 * g + 1) * (ROWS + PAD) + r] = x.y * scale;
    dst[(4 * g + 2) * (ROWS + PAD) + r] = x.z * scale;
    dst[(4 * g + 3) * (ROWS + PAD) + r] = x.w * scale;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Hq,
                       int Hkv, int Sq, int Skv, int d_true, int vec,
                       int causal, float scale, Strides sq, Strides sk,
                       Strides sv, Strides so) {
  // D is the instantiated head dim, d_true <= D the tensors' own
  constexpr int OC = D >= 16 ? D / 16 : 1;  // output columns per thread
  constexpr int QS = BQ + PAD, KS = BKV + PAD;
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [D][QS]   q / sqrt(D)
  float* kT = qT + D * QS;                      // [D][KS]
  float* vs = kT + D * KS;                      // [BKV][D]
  float* pT = vs + BKV * D;                     // [BKV][QS]

  const int tid = threadIdx.x;
  const int rg = tid / 16, cg = tid % 16;
  const bool owner = cg * OC < D;  // holds output columns (all when D >= 16)
  const int q0 = ((int)gridDim.x - 1 - (int)blockIdx.x) * BQ;
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  T* ob = o + b * so.b + h * so.h;

  stage_transposed<T, D, BQ>(qT, qb, sq.s, q0, Sq, d_true, vec, scale);

  float m[4], l[4], acc[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OC; ++j) acc[i][j] = 0.f;
  }

  // kv tiles the block's rows can see: all, or up to its last valid row
  int n_kv = (Skv + BKV - 1) / BKV;
  if (causal) n_kv = min(n_kv, (min(q0 + BQ, Sq) - 1) / BKV + 1);

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // the previous tile's readers of kT / vs / pT are done
    stage_transposed<T, D, BKV>(kT, kb, sk.s, k0, Skv, d_true, vec, 1.f);
    for (int idx = tid; idx < BKV * (D / 4); idx += THREADS) {
      const int g = idx % (D / 4), r = idx / (D / 4);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < Skv) x = load_cols(vb + (k0 + r) * sv.s, g, d_true, vec);
      *reinterpret_cast<float4*>(vs + r * D + 4 * g) = x;
    }
    __syncthreads();

    // scores s[i][j] of rows 4 rg + i against columns 4 cg + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(qT + d * QS + 4 * rg);
      const float4 kv = *reinterpret_cast<const float4*>(kT + d * KS + 4 * cg);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

    // mask, online softmax per row (16 threads share a row)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * rg + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + 4 * cg + j;
        if (kp >= Skv || (causal && qp < kp)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < OC; ++j) acc[i][j] *= alpha;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pT + (4 * cg + j) * QS + 4 * rg) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc[i][:] += p[row i][:] · v[:][cols]
    if (owner) {
      const int kv_n = min(BKV, Skv - k0);
#pragma unroll 4
      for (int c = 0; c < kv_n; ++c) {
        const float4 pv = *reinterpret_cast<const float4*>(pT + c * QS + 4 * rg);
        const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
        float va[OC];
        if constexpr (OC % 4 == 0) {
#pragma unroll
          for (int j = 0; j < OC; j += 4) {
            const float4 x = *reinterpret_cast<const float4*>(vs + c * D + cg * OC + j);
            va[j] = x.x;
            va[j + 1] = x.y;
            va[j + 2] = x.z;
            va[j + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < OC; ++j) va[j] = vs[c * D + cg * OC + j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < OC; ++j) acc[i][j] = fmaf(pa[i], va[j], acc[i][j]);
      }
    }
  }

  if (owner) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + 4 * rg + i;
      if (qp >= Sq) continue;
      const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int j = 0; j < OC; ++j)
        if (cg * OC + j < d_true)
          store1(ob + qp * so.s + cg * OC + j, acc[i][j] / denom);
    }
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)D * (BQ + PAD) + (size_t)D * (BKV + PAD) +
                          (size_t)BKV * D + (size_t)BKV * (BQ + PAD));
}

template <typename T, int D>
static int launch(const void* q, const void* k, const void* v, void* o, int B,
                  int Hq, int Hkv, int Sq, int Skv, int d_true, int vec,
                  int causal, float scale, Strides sq, Strides sk,
                  Strides sv, Strides so, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  flash_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, d_true,
      vec, causal, scale, sq, sk, sv, so);
  return (int)cudaGetLastError();
}

// The CUDA-core body instantiated at head dim dp (CORE_HEAD_DIMS in
// kernels/flash_attention.py) for tensors of head dim d_true <= dp.
template <typename T>
static int launch_d(int dp, const void* q, const void* k, const void* v,
                    void* o, int B, int Hq, int Hkv, int Sq, int Skv,
                    int d_true, int vec, int causal, float scale, Strides sq,
                    Strides sk, Strides sv, Strides so, cudaStream_t stream) {
#define FA_CORE_CASE(DP)                                                    \
  case DP:                                                                  \
    return launch<T, DP>(q, k, v, o, B, Hq, Hkv, Sq, Skv, d_true, vec,      \
                         causal, scale, sq, sk, sv, so, stream);
  if (d_true < 1 || d_true > dp) return (int)cudaErrorInvalidValue;
  switch (dp) {
    FA_CORE_CASE(8)
    FA_CORE_CASE(16)
    FA_CORE_CASE(32)
    FA_CORE_CASE(64)
    FA_CORE_CASE(128)
    FA_CORE_CASE(160)
    FA_CORE_CASE(256)
  }
#undef FA_CORE_CASE
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The bf16 tensor-core body (D in 16, 32, 64, 128, 160)
// ---------------------------------------------------------------------------

namespace tc {

constexpr int CONSUMERS = 2;   // consumer warpgroups, 64 q rows each
constexpr int Q_ROWS = 64 * CONSUMERS;
constexpr int BLOCK_THREADS = 128 * (CONSUMERS + 1);  // + the producer's
constexpr int KV_ROWS = 64;    // kv rows per tile
constexpr int STAGES = 3;      // k/v tiles in flight
constexpr uint32_t HI16 = 0xffff0000u;

// Shared-memory geometry of a head dimension: the tiles are stored as
// CH-column chunks of ROWB = 2·CH bytes per row, ROWB being the TMA /
// wgmma swizzle span (32, 64 or 128 bytes); D = 128 is two 64-column
// chunks side by side, D = 160 five 32-column ones (64 does not divide
// it).
template <int D>
struct Geo {
  static constexpr int CH = D < 64 ? D : D % 64 ? 32 : 64;
  static constexpr int ROWB = 2 * CH;
  static constexpr uint32_t LAYOUT = ROWB == 128 ? 1 : ROWB == 64 ? 2 : 3;
  static constexpr int SBO = 8 * ROWB;           // one 8-row swizzle atom
  static constexpr int Q_CHUNK = Q_ROWS * ROWB, KV_CHUNK = KV_ROWS * ROWB;
  static constexpr int Q_BYTES = Q_ROWS * D * 2, KV_BYTES = KV_ROWS * D * 2;
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 4-D (D, S, H, B) tensor map into shared memory,
// completing `bytes` of the barrier's transaction count.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout (1 = 128 B, 2 = 64
// B, 3 = 32 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that writes it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// S[64 x 64] (+)= A·Bᵀ, A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31},"
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O[64 x 16] (+)= A·B, A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t* a,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// O[64 x 32] (+)= A·B, A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t* a,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// O[64 x 64] (+)= A·B, A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31},"
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// O[64 x 128] (+)= A·B, A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// O[64 x 160] (+)= A·B, A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[80], const uint32_t* a,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
      "%71, %72, %73, %74, %75, %76, %77, %78, %79},"
      "{%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// The top 16 bits of x and y (x low): two bf16 values rounded toward zero.
__device__ __forceinline__ uint32_t pack_hi(float x, float y) {
  return __byte_perm(__float_as_uint(x), __float_as_uint(y), 0x7632);
}
// x minus its top 16 bits: exact in float32
__device__ __forceinline__ float low_part(float x) {
  return x - __uint_as_float(__float_as_uint(x) & HI16);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from reusing the registers of a wgmma's A operand
// before the wgmma has completed
__device__ __forceinline__ void fence_regs(uint32_t (&r)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// S = Q·Kᵀ of one kv tile into sc (asynchronous: one wgmma group), one
// wgmma per 16 columns of D; Q and K K-major, chunk by chunk.  q_desc and
// k_desc describe the tiles' first chunk; an offset of the start address
// (16-byte units, low bits of the descriptor) walks the rest.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[32], uint64_t q_desc,
                                         uint64_t k_desc) {
  using G = Geo<D>;
  wg_fence();
  fence_regs(sc);
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 / G::CH, off = (ks * 16 % G::CH) * 2;
    wgmma_ss_n64(sc, q_desc + ((c * G::Q_CHUNK + off) >> 4),
                 k_desc + ((c * G::KV_CHUNK + off) >> 4), ks > 0);
  }
  wg_commit();
}

// pv = P·V of one kv tile (asynchronous: one wgmma group): per 16 kv rows
// three wgmmas, A = one term of P from registers (smallest first), B = the
// V tile MN-major (v_desc), into a fresh float32 accumulator
template <int D>
__device__ __forceinline__ void issue_pv(float (&pv)[D / 2],
                                         const uint32_t (&p_hi)[16],
                                         const uint32_t (&p_mid)[16],
                                         const uint32_t (&p_lo)[16],
                                         uint64_t v_desc) {
  using G = Geo<D>;
  wg_fence();
  fence_regs(pv);
#pragma unroll
  for (int kk = 0; kk < KV_ROWS / 16; ++kk) {
    const uint64_t dv = v_desc + ((kk * 16 * G::ROWB) >> 4);
    wgmma_rs(pv, p_lo + 4 * kk, dv, kk > 0);
    wgmma_rs(pv, p_mid + 4 * kk, dv, 1);
    wgmma_rs(pv, p_hi + 4 * kk, dv, 1);
  }
  wg_commit();
}

// After a P·V group has completed: acc = acc·alpha + pv (one FMA an
// element), and the registers it read are free again
template <int N>
__device__ __forceinline__ void fold(float (&acc)[N], float (&pv)[N],
                                     const float (&alpha)[2],
                                     uint32_t (&p_hi)[16],
                                     uint32_t (&p_mid)[16],
                                     uint32_t (&p_lo)[16]) {
  fence_regs(pv);
  fence_regs(p_hi);
  fence_regs(p_mid);
  fence_regs(p_lo);
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], pv[i]);
}

// Online softmax of one tile of raw scores sc (row ra + 8·((i >> 1) & 1),
// column k0 + 8·(i / 4) + cq + (i & 1)): mask with -1e30 (EDGE: diagonal
// and ragged tiles; instantiated apart, so other tiles spend nothing on
// it), update the running max m (raw units) and sum l, and leave p =
// 2^(s·c − m·c) in sc, c = log2(e)/sqrt(D); alpha the factor of the
// running output.  Each row is shared by 4 threads (lanes ^1, ^2).
template <bool EDGE>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int k0, int ra, int cq, int Skv,
                                             int causal, float c) {
  // 4 partial maxima and sums per row: short dependency chains
  float mx[2][4], rs[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      mx[r][j] = j == 0 ? m[r] : NEG_INF;
      rs[r][j] = 0.f;
    }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if constexpr (EDGE) {
      const int kp = k0 + 8 * (i / 4) + cq + (i & 1);
      const int qp = ra + 8 * ((i >> 1) & 1);
      if (kp >= Skv || (causal && qp < kp)) sc[i] = NEG_INF;
    }
    float& x = mx[(i >> 1) & 1][(i & 1) | ((i >> 1) & 2)];
    x = fmaxf(x, sc[i]);
  }
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    alpha[r] = ex2((m[r] - v) * c);
    m[r] = v;
    mc[r] = v * c;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = ex2(fmaf(sc[i], c, -mc[(i >> 1) & 1]));
    rs[(i >> 1) & 1][(i & 1) | ((i >> 1) & 2)] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float v = (rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]);
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    l[r] = l[r] * alpha[r] + v;
  }
}

// p = hi + mid + lo exactly, each term a bf16 (the top 8 significant bits
// of what is left), packed as wgmma A fragments: register 4·kk + j holds
// p[2(4kk + j)] (low half) and p[2(4kk + j) + 1]
__device__ __forceinline__ void split_p(const float (&sc)[32],
                                        uint32_t (&p_hi)[16],
                                        uint32_t (&p_mid)[16],
                                        uint32_t (&p_lo)[16]) {
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const float x0 = sc[2 * n], x1 = sc[2 * n + 1];
    const float r0 = low_part(x0), r1 = low_part(x1);
    p_hi[n] = pack_hi(x0, x1);
    p_mid[n] = pack_hi(r0, r1);
    p_lo[n] = pack_hi(low_part(r0), low_part(r1));
  }
}


template <int D>
__global__ void __launch_bounds__(BLOCK_THREADS, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          __nv_bfloat16* __restrict__ o, int Hq, int Hkv,
                          int Sq, int Skv, int d_true, int causal,
                          float scale, Strides so) {
  // D is the instantiated head dim; columns d_true .. D - 1 of the tiles
  // are TMA's zeros and are not stored
  using G = Geo<D>;
  extern __shared__ uint8_t smem_raw[];
  // tiles on 1024-byte boundaries: the swizzle pattern repeats every 8 rows
  uint8_t* sQ = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = sQ + G::Q_BYTES;
  uint8_t* sV = sK + STAGES * G::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sQ + G::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  // longest causal tiles first
  const int q0 = ((int)gridDim.y - 1 - (int)blockIdx.y) * Q_ROWS;
  const int n_all = (Skv + KV_ROWS - 1) / KV_ROWS;
  // kv tiles the rows from r0 (64 of them; the block's: Q_ROWS) see
  auto tiles_of = [&](int r0, int rows) {
    if (r0 >= Sq) return 0;
    return causal ? min(n_all, (min(r0 + rows, Sq) - 1) / KV_ROWS + 1)
                  : n_all;
  };
  const int n_kv = tiles_of(q0, Q_ROWS);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, 4 * CONSUMERS);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warpgroup index, through a shuffle so the compiler knows it is
  // uniform (the wgmma descriptors derived from it stay scalar)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == CONSUMERS) {
    // producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(q_full, G::Q_BYTES);
#pragma unroll
      for (int c = 0; c < D / G::CH; ++c)
        tma_load(sQ + c * G::Q_CHUNK, &tq, q_full, c * G::CH, q0, h, b);
      for (int kt = 0; kt < n_kv; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty + s, (kt / STAGES - 1) & 1);
        // the consumer warps whose rows do not see this tile release it
        // here (each consumer arrives only for the tiles it computes)
        int idle = 0;
#pragma unroll
        for (int w = 0; w < CONSUMERS; ++w)
          idle += kt >= tiles_of(q0 + 64 * w, 64);
        if (idle) mbar_arrive(empty + s, 4 * idle);
        mbar_expect_tx(k_full + s, G::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / G::CH; ++c)
          tma_load(sK + s * G::KV_BYTES + c * G::KV_CHUNK, &tk, k_full + s,
                   c * G::CH, kt * KV_ROWS, hk, b);
        mbar_expect_tx(v_full + s, G::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / G::CH; ++c)
          tma_load(sV + s * G::KV_BYTES + c * G::KV_CHUNK, &tv, v_full + s,
                   c * G::CH, kt * KV_ROWS, hk, b);
      }
    }
  } else {
    // consumer warpgroup wg: q rows row0 .. row0 + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int row0 = q0 + 64 * wg;
    const int ra = row0 + 16 * warp + lane / 4;  // its rows: ra, ra + 8
    const int cq = 2 * (lane % 4);               // columns cq, cq + 1 of 8
    const float c = scale * 1.44269504088896341f;  // log2(e) / sqrt(D)
    const int n_mine = tiles_of(row0, 64);

    float acc[D / 2], pv[D / 2], sc[32], alpha[2];
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    uint32_t p_hi[16], p_mid[16], p_lo[16];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(q_full, 0);
    const uint64_t q_desc = smem_desc(smem_u32(sQ) + 64 * wg * G::ROWB, 16,
                                      G::SBO, G::LAYOUT);
    const uint64_t k_desc = smem_desc(smem_u32(sK), 16, G::SBO, G::LAYOUT);
    const uint64_t v_desc =
        smem_desc(smem_u32(sV), G::KV_CHUNK, G::SBO, G::LAYOUT);
    constexpr int STAGE16 = G::KV_BYTES >> 4;   // a stage, 16-byte units

    // While one consumer warpgroup waits on its wgmmas, the other's
    // softmax has the CUDA cores: the two overlap with no further
    // scheduling (turns taken over named barriers, or a software pipeline
    // of QKᵀ of tile j with P·V of tile j-1, measured no faster).
    for (int kt = 0; kt < n_mine; ++kt) {
      const int s = kt % STAGES, par = (kt / STAGES) & 1;
      mbar_wait(k_full + s, par);
      issue_qk<D>(sc, q_desc, k_desc + s * STAGE16);
      wg_wait();
      fence_regs(sc);
      // masks only where the tile reaches past row0 or past Skv
      const int k_end = (kt + 1) * KV_ROWS;
      if ((causal && k_end - 1 > row0) || k_end > Skv)
        softmax_tile<true>(sc, m, l, alpha, kt * KV_ROWS, ra, cq, Skv,
                           causal, c);
      else
        softmax_tile<false>(sc, m, l, alpha, kt * KV_ROWS, ra, cq, Skv,
                            causal, c);
      split_p(sc, p_hi, p_mid, p_lo);
      mbar_wait(v_full + s, par);
      issue_pv<D>(pv, p_hi, p_mid, p_lo, v_desc + s * STAGE16);
      wg_wait();
      fold(acc, pv, alpha, p_hi, p_mid, p_lo);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }

    // epilogue: acc / max(l, 1e-30) as bf16, rows ra and ra + 8
    if (n_mine > 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qp = ra + 8 * r;
        if (qp >= Sq) continue;
        const float denom = fmaxf(l[r], 1e-30f);
        __nv_bfloat16* orow = o + b * so.b + h * so.h + qp * so.s + cq;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          if (D == d_true || 8 * j < d_true)  // d_true: a multiple of 16
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
                __floats2bfloat162_rn(acc[4 * j + 2 * r] / denom,
                                      acc[4 * j + 2 * r + 1] / denom);
      }
    }
  }
}

}  // namespace tc

// errors of the tensor-core launch besides cudaError_t
#define ERR_NO_ENCODER (-1)
#define ERR_ENCODE (-2)

// cuTensorMapEncodeTiled from the driver, through the runtime's entry-point
// query: no link against libcuda
static PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A bf16 (D, S, H, B) tensor map: dims and byte strides (S, H, B) of the
// tensor, box (CH, rows, 1, 1), swizzled as the box's row bytes.
static int encode(CUtensorMap* map, const void* ptr, const uint64_t* dims,
                  const uint64_t* strides, const uint32_t* box) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = encode_tiled();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const uint32_t one[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = box[0] * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : box[0] * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                    : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, one,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

template <int D>
static int launch_tc(const void* q, const void* k, const void* v, void* o,
                     const uint64_t* dims, const uint64_t* strides,
                     const uint32_t* boxes, int Hq, int Hkv, int Sq, int Skv,
                     int d_true, int causal, float scale, Strides so,
                     int grid_x, int grid_y, cudaStream_t stream) {
  using G = tc::Geo<D>;
  // the plan's boxes must be the geometry this instantiation reads, over
  // tensors of head dim d_true (a multiple of 16 up to D)
  if (d_true > D || d_true % 16 || dims[0] != (uint64_t)d_true ||
      boxes[0] != G::CH || boxes[1] != tc::Q_ROWS || boxes[4] != G::CH ||
      boxes[5] != tc::KV_ROWS || boxes[8] != G::CH || boxes[9] != tc::KV_ROWS)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  int e = encode(&tq, q, dims, strides, boxes);
  if (e == 0) e = encode(&tk, k, dims + 4, strides + 3, boxes + 4);
  if (e == 0) e = encode(&tv, v, dims + 8, strides + 6, boxes + 8);
  if (e != 0) return e;
  // the shared-memory attribute, once per device (it holds for the process)
  static bool sized[64] = {};
  int dev = 0;
  cudaError_t r = cudaGetDevice(&dev);
  if (r != cudaSuccess) return (int)r;
  if (dev >= 64 || !sized[dev]) {
    r = cudaFuncSetAttribute(tc::flash_attention_tc_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G::SMEM);
    if (r != cudaSuccess) return (int)r;
    if (dev < 64) sized[dev] = true;
  }
  tc::flash_attention_tc_kernel<D><<<dim3(grid_x, grid_y), tc::BLOCK_THREADS,
                                     G::SMEM, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Hq, Hkv, Sq, Skv, d_true,
      causal, scale, so);
  return (int)cudaGetLastError();
}

extern "C" {

// Launches the CUDA-core body instantiated at head dim dp on `stream` for
// tensors of head dim D <= dp, with 4-element vector loads if vec;
// dtype 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int Hq, int Hkv, int Sq, int Skv,
                           int D, int dp, int vec, int causal, int dtype,
                           float scale,
                           long long qb, long long qh, long long qs,
                           long long kb, long long kh, long long ks,
                           long long vb, long long vh, long long vs,
                           long long ob, long long oh, long long os,
                           void* stream) {
  const Strides sq{qb, qh, qs}, sk{kb, kh, ks}, sv{vb, vh, vs}, so{ob, oh, os};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(dp, q, k, v, o, B, Hq, Hkv, Sq, Skv, D, vec,
                           causal, scale, sq, sk, sv, so, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(dp, q, k, v, o, B, Hq, Hkv, Sq, Skv, D,
                                   vec, causal, scale, sq, sk, sv, so, s);
  return (int)cudaErrorInvalidValue;
}

// Launches the bf16 tensor-core body on `stream`.  `params` (int64, one
// array so that a call converts few arguments): the TMA dims (4), byte
// strides (3) and boxes (4) of q, then of k, then of v; Hq, Hkv, Sq, Skv,
// D (the tensors'), the instantiated head dim, causal; o's element
// strides (batch, head, position); the grid (B·Hq, q tiles).  Returns a cudaError_t, or ERR_NO_ENCODER / ERR_ENCODE.
int flash_attention_tc_launch(const void* q, const void* k, const void* v,
                              void* o, const long long* params,
                              void* stream) {
  uint64_t dims[12], strides[9];
  uint32_t boxes[12];
  for (int t = 0; t < 3; ++t) {
    const long long* p = params + 11 * t;
    for (int i = 0; i < 4; ++i) dims[4 * t + i] = (uint64_t)p[i];
    for (int i = 0; i < 3; ++i) strides[3 * t + i] = (uint64_t)p[4 + i];
    for (int i = 0; i < 4; ++i) boxes[4 * t + i] = (uint32_t)p[7 + i];
  }
  const long long* p = params + 33;
  const int Hq = (int)p[0], Hkv = (int)p[1], Sq = (int)p[2], Skv = (int)p[3];
  const int D = (int)p[4], dp = (int)p[5], causal = (int)p[6];
  const Strides so{p[7], p[8], p[9]};
  const int gx = (int)p[10], gy = (int)p[11];
  const float scale = (float)(1.0 / sqrt((double)D));  // the true D's
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dp) {
    case 16: return launch_tc<16>(q, k, v, o, dims, strides, boxes, Hq, Hkv, Sq, Skv, D, causal, scale, so, gx, gy, s);
    case 32: return launch_tc<32>(q, k, v, o, dims, strides, boxes, Hq, Hkv, Sq, Skv, D, causal, scale, so, gx, gy, s);
    case 64: return launch_tc<64>(q, k, v, o, dims, strides, boxes, Hq, Hkv, Sq, Skv, D, causal, scale, so, gx, gy, s);
    case 128: return launch_tc<128>(q, k, v, o, dims, strides, boxes, Hq, Hkv, Sq, Skv, D, causal, scale, so, gx, gy, s);
    case 160: return launch_tc<160>(q, k, v, o, dims, strides, boxes, Hq, Hkv, Sq, Skv, D, causal, scale, so, gx, gy, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the tensor-core body at head dim D (0 if none).
int flash_attention_tc_smem(int D) {
  switch (D) {
    case 16: return tc::Geo<16>::SMEM;
    case 32: return tc::Geo<32>::SMEM;
    case 64: return tc::Geo<64>::SMEM;
    case 128: return tc::Geo<128>::SMEM;
    case 160: return tc::Geo<160>::SMEM;
  }
  return 0;
}

const char* flash_attention_error_string(int err) {
  if (err == ERR_NO_ENCODER)
    return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
  if (err == ERR_ENCODE)
    return "cuTensorMapEncodeTiled refused a q/k/v tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
