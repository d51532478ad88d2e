// Approximate-multiplier LUT matmul for Hopper (sm_90a):
//
//     C[m, n] = sum_k LUT[A[m, k], B[k, n]]     A, B uint8; LUT uint16; C int32
//
// The whole 256 x 256 product table is staged once per block into dynamic
// shared memory as uint16 (128 KB; as int32 it would be 256 KB, over the
// 227 KB a block may use), so every product is one shared-memory gather.
// Blocks are persistent: a block stages the table, then walks work items
// (output tile, K slice) with a stride of gridDim.x.  Per item, the K slice
// is consumed BK = 32 steps at a time: the A tile [BM][BK] and the B tile
// [BK][BN] are copied into shared memory (zero outside M / N), and each
// thread accumulates its TM x TN outputs in int32 registers.  A k outside
// [0, K) is never looked up (the last, partial step runs a bounds-checked
// loop), so LUT[0, 0] != 0 needs no correction; rows and columns outside
// M / N are computed from zero operands and never stored.
//
// With one K slice per tile the item stores its outputs; with several, the
// items add their int32 partials with atomicAdd into a zeroed C: integer
// addition is exact and order-free, so the result is the same bits.
//
// Plain C interface (ctypes).  The caller plans the tiles, the K split and
// the grid (kernels/lut_matmul.py::plan) and zeroes C when splits > 1.

#include <cuda_runtime.h>
#include <stdint.h>

#define BK 32
#define THREADS 256
#define LUT_BYTES (256 * 256 * 2)
#define A_PAD 4  // sA row stride BK + 4 bytes: rows TM apart hit other banks
#define MAX_DEVICES 64

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(THREADS, 1)
lut_matmul_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ B,
                  const uint16_t* __restrict__ lut, int* __restrict__ C,
                  int M, int N, int K, int tiles_n, int n_tiles, int splits,
                  int chunks_per_split) {
  static_assert((BM / TM) * (BN / TN) == THREADS, "one output block per thread");
  static_assert(TN % 4 == 0, "B is read as 4-byte words");
  extern __shared__ uint4 slut4[];                       // [LUT_BYTES / 16]
  __shared__ __align__(16) uint8_t sA[BM][BK + A_PAD];
  __shared__ __align__(16) uint8_t sB[BK][BN];
  const uint16_t* slut = reinterpret_cast<const uint16_t*>(slut4);

  const int tid = threadIdx.x;
  const uint4* lut4 = reinterpret_cast<const uint4*>(lut);
#pragma unroll 8  // keep several 16-byte loads in flight per thread
  for (int i = tid; i < LUT_BYTES / 16; i += THREADS) slut4[i] = lut4[i];

  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const bool a_vec = (K % 4 == 0) && (reinterpret_cast<uintptr_t>(A) % 4 == 0);
  const bool b_vec = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(B) % 4 == 0);
  const int n_items = n_tiles * splits;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int tile = item % n_tiles, split = item / n_tiles;
    const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
    const int k_begin = split * chunks_per_split * BK;
    const int k_end = min(K, k_begin + chunks_per_split * BK);

    int acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0;

    for (int k0 = k_begin; k0 < k_end; k0 += BK) {
      const int kn = min(BK, k_end - k0);
      __syncthreads();  // previous step's tiles consumed (and the table staged)
      if (a_vec) {  // kn is a multiple of 4 here, so a word is all in or out
        for (int i = tid; i < BM * BK / 4; i += THREADS) {
          const int r = i / (BK / 4), c = (i % (BK / 4)) * 4, m = m0 + r;
          uint32_t v = 0;
          if (m < M && c < kn)
            v = *reinterpret_cast<const uint32_t*>(A + (size_t)m * K + k0 + c);
          *reinterpret_cast<uint32_t*>(&sA[r][c]) = v;
        }
      } else {
        for (int i = tid; i < BM * BK; i += THREADS) {
          const int r = i / BK, c = i % BK, m = m0 + r;
          sA[r][c] = (m < M && c < kn) ? A[(size_t)m * K + k0 + c] : 0;
        }
      }
      if (b_vec) {  // n0 + c is a multiple of 4 and so is N
        for (int i = tid; i < BK * BN / 4; i += THREADS) {
          const int r = i / (BN / 4), c = (i % (BN / 4)) * 4, n = n0 + c;
          uint32_t v = 0;
          if (r < kn && n < N)
            v = *reinterpret_cast<const uint32_t*>(B + (size_t)(k0 + r) * N + n);
          *reinterpret_cast<uint32_t*>(&sB[r][c]) = v;
        }
      } else {
        for (int i = tid; i < BK * BN; i += THREADS) {
          const int r = i / BN, c = i % BN, n = n0 + c;
          sB[r][c] = (r < kn && n < N) ? B[(size_t)(k0 + r) * N + n] : 0;
        }
      }
      __syncthreads();

      if (kn == BK) {
#pragma unroll
        for (int kk = 0; kk < BK; kk += 4) {
          uint32_t a4[TM], b4[4][TN / 4];
#pragma unroll
          for (int i = 0; i < TM; ++i)
            a4[i] = *reinterpret_cast<const uint32_t*>(&sA[ty * TM + i][kk]);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int j = 0; j < TN / 4; ++j)
              b4[q][j] = *reinterpret_cast<const uint32_t*>(
                  &sB[kk + q][tx * TN + 4 * j]);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              const uint32_t row = ((a4[i] >> (8 * q)) & 0xffu) << 8;
#pragma unroll
              for (int j = 0; j < TN; ++j)
                acc[i][j] += slut[row | ((b4[q][j / 4] >> (8 * (j % 4))) & 0xffu)];
            }
        }
      } else {
        for (int kk = 0; kk < kn; ++kk)
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const uint32_t row = (uint32_t)sA[ty * TM + i][kk] << 8;
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] += slut[row | sB[kk][tx * TN + j]];
          }
      }
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = m0 + ty * TM + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = n0 + tx * TN + j;
        if (n >= N) continue;
        if (splits == 1)
          C[(size_t)m * N + n] = acc[i][j];
        else
          atomicAdd(&C[(size_t)m * N + n], acc[i][j]);
      }
    }
  }
}

// The two tile shapes (kernels/lut_matmul.py::TILES): 64 x 64 tiles for
// prefill (M >= 32), 4-row strips of 256 columns for decode (M < 32).
#define WIDE lut_matmul_kernel<64, 64, 4, 4>
#define STRIP lut_matmul_kernel<4, 256, 1, 4>

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
int lut_matmul_launch(const uint8_t* A, const uint8_t* B, const uint16_t* lut,
                      int* C, int M, int N, int K, int strip, int tiles_n,
                      int n_tiles, int splits, int chunks_per_split, int grid,
                      void* stream) {
  // the shared-memory opt-in holds for the function on a device: set it
  // once per (tile shape, device)
  static bool opted_in[2][MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  bool* done = dev < MAX_DEVICES ? &opted_in[strip != 0][dev] : nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (done == nullptr || !*done) {
    e = strip
        ? cudaFuncSetAttribute(STRIP, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               LUT_BYTES)
        : cudaFuncSetAttribute(WIDE, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               LUT_BYTES);
    if (e != cudaSuccess) return (int)e;
    if (done != nullptr) *done = true;
  }
  if (strip)
    STRIP<<<grid, THREADS, LUT_BYTES, s>>>(A, B, lut, C, M, N, K, tiles_n,
                                           n_tiles, splits, chunks_per_split);
  else
    WIDE<<<grid, THREADS, LUT_BYTES, s>>>(A, B, lut, C, M, N, K, tiles_n,
                                          n_tiles, splits, chunks_per_split);
  return (int)cudaGetLastError();
}

const char* lut_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
