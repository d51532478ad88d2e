// Blocked online-softmax attention, forward pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py (body
// flash_attention_kernel, wrapper flash_attention).  It computes, for every
// (batch, q-head) and query row, the causal or full softmax attention of
// q / sqrt(D) against the rows of the head's kv-head (GQA: q-head h reads
// kv-head h / (Hq / Hkv) directly, without a repeated copy), in float32:
// q, k, v upcast, q scaled first, masked logits -1e30, a running max and
// denominator per row, output acc / max(l, 1e-30) rounded to the input type.
//
// One block of 256 threads per (q tile of BQ = 64 rows, batch·head), the
// longest causal tiles first.  The block stages its q tile once (scaled,
// transposed) and walks the kv tiles of BKV = 64 rows that its rows can
// see (fully masked causal tiles are skipped), staging each k tile
// (transposed) and v tile in shared memory.  Thread (rg, cg) = (tid / 16,
// tid % 16) owns rows 4 rg .. 4 rg + 3 of the q tile: it computes their
// scores against columns 4 cg .. 4 cg + 3 of the kv tile (a 4 x 4 register
// tile over D), reduces each row's max and sum across the 16 threads that
// share it with warp shuffles, writes p to shared memory (transposed), and
// accumulates output columns cg·OC .. cg·OC + OC - 1 (OC = D / 16, or one
// column for D < 16) of its rows in registers.  Everything is float32 on
// the CUDA cores: what bounds it is the float32 FMA rate (2 FMAs per
// (row, key, d): S and P·V), at most ~1/15 of the bf16 tensor-core rate the
// card's bound is quoted at.
//
// Plain C interface (ctypes); pointers and int64 element strides for
// (batch, head, position), the last dimension contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows x D of `src` (rows from `row0`, `n_rows` valid, scaled by `scale`)
// into dst[d][row] with row stride ROWS + PAD: consecutive threads take
// consecutive rows, so the transposed stores hit consecutive banks
template <typename T, int D, int ROWS>
__device__ __forceinline__ void stage_transposed(float* dst, const T* src,
                                                 long long stride, int row0,
                                                 int n_rows, float scale) {
  for (int idx = threadIdx.x; idx < ROWS * (D / 4); idx += THREADS) {
    const int r = idx % ROWS, g = idx / ROWS;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows) x = load4(src + (row0 + r) * stride + 4 * g);
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
                       int Hkv, int Sq, int Skv, int causal, float scale,
                       Strides sq, Strides sk, Strides sv, Strides so) {
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

  stage_transposed<T, D, BQ>(qT, qb, sq.s, q0, Sq, scale);

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
    stage_transposed<T, D, BKV>(kT, kb, sk.s, k0, Skv, 1.f);
    for (int idx = tid; idx < BKV * (D / 4); idx += THREADS) {
      const int g = idx % (D / 4), r = idx / (D / 4);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k0 + r < Skv) x = load4(vb + (k0 + r) * sv.s + 4 * g);
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
                  int Hq, int Hkv, int Sq, int Skv, int causal, float scale,
                  Strides sq, Strides sk, Strides sv, Strides so,
                  cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  flash_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, Hkv, Sq, Skv, causal,
      scale, sq, sk, sv, so);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_d(int D, const void* q, const void* k, const void* v,
                    void* o, int B, int Hq, int Hkv, int Sq, int Skv,
                    int causal, float scale, Strides sq, Strides sk,
                    Strides sv, Strides so, cudaStream_t stream) {
  switch (D) {
    case 8: return launch<T, 8>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale, sq, sk, sv, so, stream);
    case 16: return launch<T, 16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale, sq, sk, sv, so, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale, sq, sk, sv, so, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale, sq, sk, sv, so, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale, sq, sk, sv, so, stream);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" {

// Launches the kernel on `stream`; dtype 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int Hq, int Hkv, int Sq, int Skv,
                           int D, int causal, int dtype, float scale,
                           long long qb, long long qh, long long qs,
                           long long kb, long long kh, long long ks,
                           long long vb, long long vh, long long vs,
                           long long ob, long long oh, long long os,
                           void* stream) {
  const Strides sq{qb, qh, qs}, sk{kb, kh, ks}, sv{vb, vh, vs}, so{ob, oh, os};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, scale,
                           sq, sk, sv, so, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, causal,
                                   scale, sq, sk, sv, so, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
