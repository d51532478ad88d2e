// Approximate-multiplier LUT matmul for Hopper (sm_90a):
//
//     C[m, n] = sum_k LUT[A[m, k], B[k, n]]     A, B uint8; LUT uint16; C int32
//
// Replaces the TPU kernel repro/kernels/lut_matmul.py (lut_matmul_kernel,
// lut_matmul) and the padding of repro/kernels/ops.py::lut_matmul.
//
// What bounds it: shared memory.  Every product is a data-dependent read of
// the 256 x 256 uint16 table.  A warp gathering 32 random entries of one
// table row from shared memory hits ~2.8 words in one bank on average, so a
// gather a product costs ~2.8 passes of the shared-memory pipe per 32
// products.  The design:
//
// * The slab.  A block owns BM = 4 or 8 rows and BN = 256 * TN columns.
//   Per k, warp k of the chunk transposes its BM rows' table rows into a
//   slab: slab_k[b] = {LUT[a_0, b], ..., LUT[a_{BM-1}, b]}, one 16-byte
//   (BM = 8) or 8-byte (BM = 4) row per b.  One vector read of
//   slab_k[B[k, n]] then gives BM products.  Slab rows are padded one row in
//   nine (lane l's eight rows start at row 9 l), so the transposing stores
//   hit distinct banks; the reader's offset is RB * (b + b / 8).
// * Two products a 32-bit add.  A slab word packs rows 2q (low half) and
//   2q + 1 (high half).  Per word the thread keeps S = sum of the words and
//   H = sum of their high halves, both mod 2^32; row 2q's sum is
//   S - (H << 16), exact mod 2^32 for any K, and row 2q + 1's is H.  Two k
//   go into one three-input add.
// * The table is staged whole (128 KB as uint16) in every block's shared
//   memory by bulk asynchronous copies (cp.async.bulk) onto an mbarrier,
//   overlapped with the first chunks' loads; the slab builds read it
//   without bank conflicts (a warp reads 512 contiguous bytes).
// * Pipelined chunks.  The A / B tiles of BK = 8 k go through a ring of 3
//   or 4 stages (as shared memory allows) with cp.async (16-byte copies,
//   zero-filled past the edges); chunk c + stages - 1 loads while chunk c
//   is used.  Shapes whose rows are not 16-byte aligned load B with plain
//   byte loads instead.
// * Split K in a cluster.  A tile's BK-step chunks are dealt into `splits`
//   slices of as equal length as can be.  The K slices of one output tile
//   are the blocks of one cluster (up to 8).  Each block writes its partial
//   tile to its own shared memory; block r of the cluster adds slice r of
//   the tile over all the blocks' copies (distributed shared memory) and
//   stores it, so C needs no zeroing.  Where a tile takes more slices than
//   a cluster holds (decode shapes), the clusters' sums go to C with atomic
//   adds and the launcher zeroes C first (cudaMemsetAsync).  Integer
//   addition is exact, so any order gives the same bits.
//
// A k outside [0, K) is never looked up: its slab is zeros.  Rows past M
// and columns past N are computed from zero operands and never stored.
//
// Compile-time switches (each undoes one design point; the shipped build
// sets none; tools/lut_matmul_ablation.py builds them):
//   SLAB=0          per-lookup gathers from the table instead of the slab,
//                   one table row a warp per lookup, at pre-shifted
//                   table-row (a << 9) and entry (b << 1) byte offsets
//   PIPELINE=0      each chunk loaded and waited for before it is used
//   NO_TABLE=1      timing only: slab rows read at a constant index
//   STAGING_ONLY=1  timing only: chunks staged, nothing computed
// The cluster size is a launch argument (kernels/lut_matmul.py::plan).
//
// Plain C interface (ctypes).  The caller plans tiles, clusters and the K
// split.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

#ifndef SLAB
#define SLAB 1
#endif
#ifndef PIPELINE
#define PIPELINE 1
#endif
#ifndef NO_TABLE
#define NO_TABLE 0
#endif
#ifndef STAGING_ONLY
#define STAGING_ONLY 0
#endif

#define BK 8           // k a chunk: one slab per warp
#define THREADS 256
#define LUT_BYTES (256 * 256 * 2)
#define ROW_BYTES 512  // one table row
#define PIECES 8       // bulk copies of the table (16 KB each)
#define SMEM_LIMIT 232448
#define MAX_DEVICES 64

#if NO_TABLE
__device__ uint32_t g_index_mask = 0;  // 0 at run time; opaque to the compiler
#endif

// Shared memory: [table][BK slabs][ring of stages][mbarrier].  The partial
// tile of the epilogue reuses the slabs and the ring.
template <int BM, int TN>
struct Geo {
  static constexpr int BN = 256 * TN;                 // columns a tile
  static constexpr int RB = 2 * BM;                   // slab row bytes
  static constexpr int SLAB_K = RB * (256 + 32);      // one k's slab, padded
  static constexpr int SLABS = LUT_BYTES;
  static constexpr int RING = SLABS + BK * SLAB_K;
  static constexpr int STAGE = BK * BN + BM * BK;     // B tile, then A tile
  static constexpr int STAGES = RING + 4 * STAGE + 16 <= SMEM_LIMIT ? 4 : 3;
  static constexpr int BAR = RING + STAGES * STAGE;
  static constexpr int SMEM = BAR + 16;
  static_assert(STAGE % 16 == 0, "stages stay 16-byte aligned");
  static_assert(SMEM <= SMEM_LIMIT, "fits a block's shared memory");
  static_assert(BM * BN * 4 <= BAR - SLABS,
                "the partial tile fits the slabs and the ring");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` < 16 zero-fills the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// `bytes` of global memory into this block's shared memory, completing
// them on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t word(const uint4& v, int p) {
  return p == 0 ? v.x : p == 1 ? v.y : p == 2 ? v.z : v.w;
}

// Byte j of a little-endian run of words, zero-extended.
template <int W>
__device__ __forceinline__ uint32_t byte_of(const uint32_t (&w)[W], int j) {
  return __byte_perm(w[j >> 2], 0, 0x4440 + (j & 3));
}

// NB bytes of shared memory at a multiple of min(NB, 16) into words.
template <int NB, int W>
__device__ __forceinline__ void load_bytes(uint32_t (&w)[W], const uint8_t* p) {
  if constexpr (NB >= 16) {
#pragma unroll
    for (int i = 0; i < NB / 4; i += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(p + 4 * i);
      w[i] = v.x, w[i + 1] = v.y, w[i + 2] = v.z, w[i + 3] = v.w;
    }
  } else if constexpr (NB == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else if constexpr (NB == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    static_assert(NB == 2, "2, 4, 8 or a multiple of 16 bytes");
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  }
}

// Chunk [k0, k0 + BK) of the item into one ring stage: B's BK x BN tile,
// then A's BM x BK tile, zero outside [0, M) x [k0, kend) x [0, N).
template <int BM, int TN>
__device__ __forceinline__ void load_chunk(uint8_t* stage, const uint8_t* A,
                                           const uint8_t* B, int M, int N,
                                           int K, int m0, int n0, int k0,
                                           int kend, bool a_vec, bool b_vec) {
  using G = Geo<BM, TN>;
  const int tid = threadIdx.x;
  uint8_t* sB = stage;
  uint8_t* sA = stage + BK * G::BN;
  if (b_vec) {  // N % 16 == 0: a 16-byte run is all in or all out
#pragma unroll
    for (int i = tid; i < BK * G::BN / 16; i += THREADS) {
      const int r = i / (G::BN / 16), c = (i % (G::BN / 16)) * 16;
      const int k = k0 + r, n = n0 + c;
      const bool ok = k < kend && n < N;
      cp_async16(sB + r * G::BN + c, ok ? B + (size_t)k * N + n : B,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < BK * G::BN; i += THREADS) {
      const int r = i / G::BN, c = i % G::BN, k = k0 + r, n = n0 + c;
      sB[i] = (k < kend && n < N) ? B[(size_t)k * N + n] : 0;
    }
  }
  if (a_vec) {  // K % 8 == 0: a row's 8 bytes are all in or all out
    if (tid < BM) {
      const int m = m0 + tid;
      const bool ok = m < M && k0 < kend;
      cp_async8(sA + tid * BK, ok ? A + (size_t)m * K + k0 : A, ok ? 8 : 0);
    }
  } else if (tid < BM * BK) {
    const int r = tid / BK, c = tid % BK, m = m0 + r;
    sA[tid] = (m < M && k0 + c < kend) ? A[(size_t)m * K + k0 + c] : 0;
  }
}

template <int BM, int TN>
__global__ void __launch_bounds__(THREADS, 1)
lut_matmul_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ B,
                  const uint16_t* __restrict__ lut, int* __restrict__ C, int M,
                  int N, int K, int tiles_n, int n_tiles, int groups, int cs,
                  int chunks, int splits) {
  using G = Geo<BM, TN>;
  constexpr int BN = G::BN, RB = G::RB, STAGES = G::STAGES;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* table = smem;
  uint8_t* slab = smem + G::SLABS;
  uint8_t* ring = smem + G::RING;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + G::BAR);
  int* part = reinterpret_cast<int*>(slab);  // the partial tile, BM x BN
  const uint8_t* lut8 = reinterpret_cast<const uint8_t*>(lut);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = cs > 1 ? (int)cluster.block_rank() : 0;
  const int cid = blockIdx.x / cs, n_clusters = gridDim.x / cs;

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, LUT_BYTES);
    for (int p = 0; p < PIECES; ++p)
      bulk_copy(table + p * (LUT_BYTES / PIECES),
                lut8 + p * (LUT_BYTES / PIECES), LUT_BYTES / PIECES, bar);
  }
  __syncthreads();
  bool table_ready = false;

  const bool a_vec = (K % 8 == 0) && (reinterpret_cast<uintptr_t>(A) % 8 == 0);
  const bool b_vec = (N % 16 == 0) && (reinterpret_cast<uintptr_t>(B) % 16 == 0);
  const bool c_vec = (N % 4 == 0) && (reinterpret_cast<uintptr_t>(C) % 16 == 0);
  const int n_items = n_tiles * groups;
#if NO_TABLE
  const uint32_t index_mask = *(volatile uint32_t*)&g_index_mask;
#endif

  for (int item = cid; item < n_items; item += n_clusters) {
    const int tile = item % n_tiles, group = item / n_tiles;
    const int split = group * cs + rank;
    const int m0 = (tile / tiles_n) * BM, n0 = (tile % tiles_n) * BN;
    // chunks [c_lo, c_hi) of the tile's `chunks`, dealt as evenly as can be
    const int c_lo = (int)((long long)split * chunks / splits);
    const int c_hi = (int)((long long)(split + 1) * chunks / splits);
    const int kb = c_lo * BK, kend = min(K, c_hi * BK), nck = c_hi - c_lo;
    auto stage_of = [&](int c) { return ring + (c % STAGES) * G::STAGE; };
    auto load = [&](int c) {
      load_chunk<BM, TN>(stage_of(c), A, B, M, N, K, m0, n0, kb + c * BK,
                         kend, a_vec, b_vec);
    };

#if SLAB
    uint32_t S[TN][BM / 2], H[TN][BM / 2];
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int q = 0; q < BM / 2; ++q) S[j][q] = H[j][q] = 0;
    const int c0 = tid * TN;  // this thread's columns of the tile
#else
    constexpr int CPT = BM * TN;  // columns a thread, all of one row
    const int r = warp % BM;
    const int c0 = (warp / BM) * (32 * CPT) + lane * CPT;
    uint32_t acc[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[j] = 0;
#endif

    // One commit group a chunk: chunks 0 .. S - 2 ahead of the loop, then
    // iteration c commits chunk c + S - 1, so waiting for all but the
    // newest S - 2 groups at iteration c lands chunk c.
#if PIPELINE
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < nck) load(s);
      cp_async_commit();
    }
#endif
    for (int c = 0; c < nck; ++c) {
      const int k0 = kb + c * BK, kn = min(BK, kend - k0);
      uint8_t* stage = stage_of(c);
#if PIPELINE
      cp_async_wait<STAGES - 2>();
      __syncthreads();  // chunk c landed; chunk c - 1 and its slabs are used
      if (c + STAGES - 1 < nck) load(c + STAGES - 1);
      cp_async_commit();
#else
      __syncthreads();  // chunk c - 1 and its slabs are used
      load(c);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#endif
      if (!table_ready) {
        mbar_wait(bar, 0);
        table_ready = true;
      }
#if !STAGING_ONLY
      const uint8_t* sB = stage;
      const uint8_t* sA = stage + BK * BN;
#if SLAB
      {  // warp `warp` builds the slab of k0 + warp
        uint4 v[BM];
        const bool live = warp < kn;
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const uint8_t* row = table + (uint32_t)sA[m * BK + warp] * ROW_BYTES;
          v[m] = live ? *reinterpret_cast<const uint4*>(row + lane * 16)
                      : make_uint4(0, 0, 0, 0);
        }
        uint8_t* dst = slab + warp * G::SLAB_K + RB * 9 * lane;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const uint32_t sel = (j & 1) ? 0x7632 : 0x5410;
          uint32_t w[BM / 2];
#pragma unroll
          for (int q = 0; q < BM / 2; ++q)
            w[q] = __byte_perm(word(v[2 * q], j >> 1), word(v[2 * q + 1], j >> 1),
                               sel);
          if constexpr (BM == 8)
            *reinterpret_cast<uint4*>(dst + 16 * j) =
                make_uint4(w[0], w[1], w[2], w[3]);
          else
            *reinterpret_cast<uint2*>(dst + 8 * j) = make_uint2(w[0], w[1]);
        }
      }
      __syncthreads();
      using Row = typename std::conditional<BM == 8, uint4, uint2>::type;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 2) {
        constexpr int W = (TN + 3) / 4;
        uint32_t b0[W], b1[W];
        load_bytes<TN>(b0, sB + kk * BN + c0);
        load_bytes<TN>(b1, sB + (kk + 1) * BN + c0);
        const uint8_t* s0 = slab + kk * G::SLAB_K;
        const uint8_t* s1 = s0 + G::SLAB_K;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          uint32_t t0 = byte_of(b0, j), t1 = byte_of(b1, j);
#if NO_TABLE
          t0 = (t0 & index_mask) + j, t1 = (t1 & index_mask) + j;
#endif
          const Row x = *reinterpret_cast<const Row*>(s0 + RB * (t0 + (t0 >> 3)));
          const Row y = *reinterpret_cast<const Row*>(s1 + RB * (t1 + (t1 >> 3)));
          const uint32_t* xw = reinterpret_cast<const uint32_t*>(&x);
          const uint32_t* yw = reinterpret_cast<const uint32_t*>(&y);
#pragma unroll
          for (int q = 0; q < BM / 2; ++q) {
            S[j][q] += xw[q] + yw[q];
            H[j][q] += (xw[q] >> 16) + (yw[q] >> 16);
          }
        }
      }
#else   // per-lookup gathers from the table
      constexpr int W = CPT / 4;
      auto row_of = [](uint32_t a) -> uint32_t { return a << 9; };
      auto lookup = [&](uint32_t a, uint32_t t) -> uint32_t {
        return *reinterpret_cast<const uint16_t*>(table + a + 2 * t);
      };
      if (kn == BK) {
#pragma unroll
        for (int kk = 0; kk < BK; kk += 2) {
          const uint32_t a0 = row_of(sA[r * BK + kk]);
          const uint32_t a1 = row_of(sA[r * BK + kk + 1]);
          uint32_t b0[W], b1[W];
          load_bytes<CPT>(b0, sB + kk * BN + c0);
          load_bytes<CPT>(b1, sB + (kk + 1) * BN + c0);
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            acc[j] += lookup(a0, byte_of(b0, j)) + lookup(a1, byte_of(b1, j));
        }
      } else {
        for (int kk = 0; kk < kn; ++kk) {
          const uint32_t a0 = row_of(sA[r * BK + kk]);
          uint32_t b0[W];
          load_bytes<CPT>(b0, sB + kk * BN + c0);
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[j] += lookup(a0, byte_of(b0, j));
        }
      }
#endif  // SLAB
#endif  // !STAGING_ONLY
    }
    cp_async_wait<0>();
    __syncthreads();  // the slabs and the ring are free

    // this block's partial tile into its shared memory, row-major
#if SLAB
#pragma unroll
    for (int q = 0; q < BM / 2; ++q) {
      uint32_t lo[TN], hi[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) lo[j] = S[j][q] - (H[j][q] << 16), hi[j] = H[j][q];
#pragma unroll
      for (int j = 0; j < TN; j += 2) {
        *reinterpret_cast<uint2*>(part + (2 * q) * BN + c0 + j) =
            make_uint2(lo[j], lo[j + 1]);
        *reinterpret_cast<uint2*>(part + (2 * q + 1) * BN + c0 + j) =
            make_uint2(hi[j], hi[j + 1]);
      }
    }
#else
#pragma unroll
    for (int j = 0; j < CPT; j += 4)
      *reinterpret_cast<uint4*>(part + r * BN + c0 + j) =
          make_uint4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
#endif
    if (cs > 1)
      cluster.sync();
    else
      __syncthreads();

    // block `rank` adds slice `rank` of the tile over the cluster's blocks
    constexpr int QUADS = BM * BN / 4;
    const int q_lo = rank * (QUADS / cs), q_hi = q_lo + QUADS / cs;
    for (int qd = q_lo + tid; qd < q_hi; qd += THREADS) {
      int4 s = reinterpret_cast<const int4*>(part)[qd];
      for (int p = 1; p < cs; ++p) {
        const int4 v = reinterpret_cast<const int4*>(
            cluster.map_shared_rank(part, (rank + p) % cs))[qd];
        s.x += v.x, s.y += v.y, s.z += v.z, s.w += v.w;
      }
      const int m = m0 + (4 * qd) / BN, n = n0 + (4 * qd) % BN;
      if (m >= M || n >= N) continue;
      int* out = C + (size_t)m * N + n;
      const int sv[4] = {s.x, s.y, s.z, s.w};
      if (groups > 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (n + i < N) atomicAdd(out + i, sv[i]);
      } else if (c_vec) {
        *reinterpret_cast<int4*>(out) = s;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (n + i < N) out[i] = sv[i];
      }
    }
    if (cs > 1)
      cluster.sync();  // the cluster's reads of this partial tile are done
    else
      __syncthreads();
  }
  if (!table_ready) mbar_wait(bar, 0);  // no copy outlives its block
}

// The instantiations: BM in {4, 8} rows (decode, prefill) x TN in {2, 4, 8}
// (BN = 512, 1024, 2048 columns).
#define FOR_EACH_SHAPE(X) X(4, 2) X(4, 4) X(4, 8) X(8, 2) X(8, 4) X(8, 8)

typedef void (*Kernel)(const uint8_t*, const uint8_t*, const uint16_t*, int*,
                       int, int, int, int, int, int, int, int, int);

static int shape_index(int bm, int tn) {
  const int t = tn == 2 ? 0 : tn == 4 ? 1 : tn == 8 ? 2 : -1;
  if ((bm != 4 && bm != 8) || t < 0) return -1;
  return (bm == 8) * 3 + t;
}

static Kernel kernel_of(int bm, int tn, int* smem) {
#define CASE(BM_, TN_)                          \
  if (bm == BM_ && tn == TN_) {                 \
    *smem = Geo<BM_, TN_>::SMEM;                \
    return lut_matmul_kernel<BM_, TN_>;         \
  }
  FOR_EACH_SHAPE(CASE)
#undef CASE
  return nullptr;
}

// The shared-memory opt-in holds for a function on a device: set it once
// per (instantiation, device).
static cudaError_t opt_in(int bm, int tn, Kernel* k, int* smem) {
  static bool done[6][MAX_DEVICES] = {};
  const int si = shape_index(bm, tn);
  *k = si < 0 ? nullptr : kernel_of(bm, tn, smem);
  if (*k == nullptr) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && done[si][dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(*k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           *smem);
  if (e == cudaSuccess && dev < MAX_DEVICES) done[si][dev] = true;
  return e;
}

static void launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                          int grid, int smem, int cs, cudaStream_t s) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(grid, 1, 1);
  cfg->blockDim = dim3(THREADS, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

extern "C" {

// Shared-memory bytes of the (bm, tn) instantiation, or -1.
int lut_matmul_smem_bytes(int bm, int tn) {
  int smem = -1;
  return kernel_of(bm, tn, &smem) ? smem : -1;
}

// Ring stages of the (bm, tn) instantiation, or -1.
int lut_matmul_stages(int bm, int tn) {
#define CASE(BM_, TN_) \
  if (bm == BM_ && tn == TN_) return Geo<BM_, TN_>::STAGES;
  FOR_EACH_SHAPE(CASE)
#undef CASE
  return -1;
}

// Clusters of `cs` blocks of the (bm, tn) instantiation that can be
// resident at once on the current device (cudaOccupancyMaxActiveClusters),
// or a negative cudaError_t.
int lut_matmul_max_clusters(int bm, int tn, int cs) {
  Kernel k;
  int smem = 0;
  cudaError_t e = opt_in(bm, tn, &k, &smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(&cfg, &attr, cs, smem, cs, 0);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, (const void*)k, &cfg);
  return e != cudaSuccess ? -(int)e : n;
}

// Launches `clusters` clusters of `cs` blocks on `stream` (after zeroing C
// there when groups > 1); returns the cudaError_t of the launch.
int lut_matmul_launch(const uint8_t* A, const uint8_t* B, const uint16_t* lut,
                      int* C, int M, int N, int K, int bm, int tn, int tiles_n,
                      int n_tiles, int groups, int cs, int chunks,
                      int clusters, void* stream) {
  Kernel k;
  int smem = 0;
  cudaError_t e = opt_in(bm, tn, &k, &smem);
  if (e != cudaSuccess) return (int)e;
  // the epilogue deals a tile's BM * BN / 4 quads evenly over the cluster:
  // cs is a power of two up to 8
  if (cs < 1 || cs > 8 || (cs & (cs - 1)) != 0 || clusters < 1 ||
      groups < 1 || cs * groups > chunks)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (groups > 1) {
    e = cudaMemsetAsync(C, 0, (size_t)M * N * sizeof(int), s);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(&cfg, &attr, clusters * cs, smem, cs, s);
  e = cudaLaunchKernelEx(&cfg, k, A, B, lut, C, M, N, K, tiles_n, n_tiles,
                         groups, cs, chunks, cs * groups);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* lut_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
