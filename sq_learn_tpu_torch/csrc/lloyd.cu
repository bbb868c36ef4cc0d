// Fused Lloyd step for NVIDIA Hopper (sm_90a), restarts batched.
//
// Replaces the TPU kernel `lloyd_step_pallas` (tile body
// `_make_lloyd_kernel`) of sq_learn_tpu/ops/pallas_kernels.py. For each
// restart r and sample i it computes d2 = ||x||^2 + ||c||^2 - 2 x.c (f32
// accumulation, no 0-clamp), the label (argmin of d2, or with window > 0
// the argmax of the Gumbel operand over {c : d2 <= min + window}; ties go to
// the lowest index in both cases, as jnp.argmin/argmax do), min_d2, and the
// weighted per-cluster sums (k, m), counts (k) and inertia sum(w * min_d2).
//
// Bound on an H100 SXM at the q-means slice shape (n=70000, m=784, k=10,
// R=10 restarts, float32): the function needs 2*n*m*k*R + n*m*R + n*m =
// 11.58 G f32 operations (distance products; then w*x, the same for every
// restart, and one add per restart for the weighted sums), 0.173 ms at
// 67 TFLOP/s outside the tensor cores, and moves 254 MB if X is read once
// (0.08 ms at 3.35 TB/s): bound by operations.
//
// The first design (one block per row range and restart) took 22x that
// bound. It read X once per restart (2.195 GB), each product loaded one
// center value from shared memory with no reuse across rows, and its fold
// re-read the tile's rows once per restart. This design:
//  - reads X from device memory twice per launch, whatever R is: once in
//    the scoring kernel and once in the fold kernel (0.44 GB, 0.13 ms at the
//    slice shape). Where a block scores more columns than one tile holds
//    (R*k > 128), its later column tiles re-read its rows from L2;
//  - scoring (`lloyd_score`): a block owns kBM = 64 rows and computes their
//    products with the columns (active restart, center) as a register-tiled
//    f32 product: 16 x 16 threads each hold 4 rows x 8 columns, so each x
//    value loaded from shared memory serves 8 columns and each center value
//    4 rows. X and the centers are staged kBK = 64 columns at a time through
//    double-buffered cp.async stages; padding columns are neither copied nor
//    multiplied past their group of 16. Each product is the sum of kBK-term
//    register sums (a single m-term chain errs several times more: the
//    window decision needs the error well under window / 3). Then one owner
//    thread per (row, restart) takes the argmin or the window pick and
//    writes the label and min_d2. A restart spans column tiles only when
//    k > 128; its totals then live in a global scratch buffer;
//  - folding (`lloyd_fold`): a (row split x 64-column chunk) grid. Each block
//    keeps the partial sums of its chunk for every active restart in shared
//    memory. 32-row tiles of X stream through a cp.async ring; w*x is
//    rounded once per tile; a warp sorts each restart's rows by label and
//    then folds the restart, lane l owning columns l and l + 32, adding in
//    registers along each label's run, rows in order. The blocks of the
//    first chunk also sum counts and inertia, one owner thread each;
//  - `lloyd_reduce` sums the splits' partials in split order. There are no
//    float atomics: every output is bit-identical from run to run, and
//    counts of unit weights are exact integers;
//  - the optional `active` (R) mask is compacted on the device by every
//    block: the column tiles and the fold hold active restarts only, an
//    inactive restart costs no products, and its outputs are zeros. A
//    restart's results do not depend on which others are active.
//
// Precision: the f32 path is f32 FMA throughout (no TF32, no tensor cores).
// The bf16 path loads X in bf16 and accumulates in f32 on the same code;
// the centers arrive as f32 values already rounded to bf16, and the
// weighted rows w*x are rounded once to bf16 before they are summed, as the
// TPU kernel does.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o liblloyd.so lloyd.cu
// The C entry point returns a cudaError_t code (0 on success); it launches
// on the given stream and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

// scoring: a kBM x kBN tile of (row, column) products, kRG x 16 threads of
// kTM x kTN each (measured on an H100: 8 x 8 tiles with one block per SM,
// 512-thread blocks and deeper pipelines were all slower)
constexpr int kSThreads = 256;
constexpr int kSBlocks = 2;          // resident scoring blocks per SM
constexpr int kTM = 4;
constexpr int kTN = 8;
constexpr int kRG = kSThreads / 16;  // row groups
constexpr int kBM = kRG * kTM;
constexpr int kBN = 16 * kTN;
constexpr int kBK = 64;         // columns of X staged per chunk
constexpr int kLd = kBK + 4;    // stage row stride: 16-byte rows, float4
                                // reads free of bank conflicts
constexpr int kStages = 2;      // cp.async pipeline depth
constexpr int kStage = (kBM + kBN) * kLd;  // floats in one stage
constexpr int kLdD = kBM + 2;   // dot totals, (column, row): stride 66
                                // keeps stores and row reads conflict-free
static_assert(kBN * kLdD <= kStages * kStage, "D aliases the stages");
// folding
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFR = 32;       // rows per tile: one per lane of the sorting warp
constexpr int kJ = 64;        // columns a block owns: two per lane
constexpr int kFStages = 3;   // cp.async ring of fold tiles
constexpr int kPerThread = kFR * kJ / kThreads;  // w*x a thread rounds
static_assert(kFR * kJ <= 2048, "a run entry keeps the row offset in 11 bits");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// w*x rounded once into the GEMM dtype (identity for f32)
__device__ __forceinline__ float weighted(float x, float w, float) {
  return __fmul_rn(x, w);
}
__device__ __forceinline__ float weighted(float x, float w, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(x, w)));
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The active restarts in order: act[a] is the a-th one and, where pos is
// given, pos[r] is the place of restart r or -1. Every thread of the block
// calls it; warp 0 computes; returns their number.
__device__ int compact_active(const int32_t* active, int R, int* act,
                              int* pos) {
  __shared__ int count;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int base = 0;
    for (int r0 = 0; r0 < R; r0 += 32) {
      const int r = r0 + lane;
      const bool on = r < R && (active == nullptr || active[r] != 0);
      const unsigned mask = __ballot_sync(0xffffffffu, on);
      const int at = base + __popc(mask & ((1u << lane) - 1u));
      if (on) act[at] = r;
      if (pos != nullptr && r < R) pos[r] = on ? at : -1;
      base += __popc(mask);
    }
    if (lane == 0) count = base;
  }
  __syncthreads();
  return count;
}

// Stage kBM rows of X, columns [k0, k0 + kBK), into dst (stride kLd); rows
// beyond n and columns beyond m are zeros. 16-byte cp.async where X is
// float32 with aligned rows, else loads converted to f32.
template <typename T>
__device__ __forceinline__ void stage_x(float* dst, const T* X, int row0,
                                        int n, int m, int k0, int vec) {
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      for (int v = threadIdx.x; v < kBM * kBK / 4; v += kSThreads) {
        const int r = v / (kBK / 4), c = (v % (kBK / 4)) * 4;
        const int i = row0 + r, j = k0 + c;
        const bool ok = i < n && j < m;
        cp_async16(dst + r * kLd + c, ok ? X + size_t(i) * m + j : X,
                   ok ? 16 : 0);
      }
      return;
    }
  }
  for (int e = threadIdx.x; e < kBM * kBK; e += kSThreads) {
    const int r = e / kBK, c = e % kBK;
    const int i = row0 + r, j = k0 + c;
    dst[r * kLd + c] = (i < n && j < m) ? to_f32(X[size_t(i) * m + j]) : 0.f;
  }
}

// Stage the center rows crow[0..kBN), columns [k0, k0 + kBK), into dst.
// A row of -1 is padding: its products are computed and never read, so it
// is not copied at all.
__device__ __forceinline__ void stage_c(float* dst, const float* C,
                                        const int* crow, int m, int k0,
                                        int vec) {
  if (vec) {
    for (int v = threadIdx.x; v < kBN * kBK / 4; v += kSThreads) {
      const int r = v / (kBK / 4), c = (v % (kBK / 4)) * 4;
      const int cr = crow[r], j = k0 + c;
      if (cr >= 0)
        cp_async16(dst + r * kLd + c, j < m ? C + size_t(cr) * m + j : C,
                   j < m ? 16 : 0);
    }
    return;
  }
  for (int e = threadIdx.x; e < kBN * kBK; e += kSThreads) {
    const int r = e / kBK, c = e % kBK;
    const int cr = crow[r], j = k0 + c;
    if (cr >= 0) dst[r * kLd + c] = j < m ? C[size_t(cr) * m + j] : 0.f;
  }
}

// The products of one staged chunk: acc[i][j] is the kBK-term sum of row
// ty + kRG i with column tx + 16 j, for the first JN column groups (the rest
// are padding and cost nothing).
template <int JN>
__device__ __forceinline__ void chunk_products(const float* xs, int tx,
                                               int ty,
                                               float (&acc)[kTM][kTN]) {
  const float* cs = xs + kBM * kLd;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < JN; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 4) {
    float4 xa[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
      xa[i] = *reinterpret_cast<const float4*>(xs + (ty + kRG * i) * kLd + kk);
#pragma unroll
    for (int j = 0; j < JN; ++j) {
      const float4 cv =
          *reinterpret_cast<const float4*>(cs + (tx + 16 * j) * kLd + kk);
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        acc[i][j] = fmaf(xa[i].x, cv.x, acc[i][j]);
        acc[i][j] = fmaf(xa[i].y, cv.y, acc[i][j]);
        acc[i][j] = fmaf(xa[i].z, cv.z, acc[i][j]);
        acc[i][j] = fmaf(xa[i].w, cv.w, acc[i][j]);
      }
    }
  }
}

size_t score_smem_bytes(int R) {
  // stages (the dot totals alias them), xsq [kBM], csq [kBN], crow [kBN],
  // act [R]
  return (size_t(kStages) * kStage + kBM + 2 * kBN + size_t(R)) * 4;
}

// Labels and min_d2 of one tile of kBM rows, for every restart.
template <typename T>
__global__ void __launch_bounds__(kSThreads, kSBlocks)
lloyd_score(const T* __restrict__ X, const float* __restrict__ xsq,
            const float* __restrict__ C, const float* __restrict__ csq,
            const float* __restrict__ gumbel,
            const int32_t* __restrict__ active, float window, int n, int m,
            int k, int R, int vec_x, int vec_c, float* d_global,
            int32_t* __restrict__ labels, float* __restrict__ min_d2) {
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);  // [kStages][kBM + kBN][kLd]
  float* xsq_s = stage + kStages * kStage;         // [kBM]
  float* csq_s = xsq_s + kBM;                      // [kBN]
  int* crow = reinterpret_cast<int*>(csq_s + kBN);  // [kBN] center rows
  int* act = crow + kBN;                            // [R]
  // the dot totals, (column, row), once the product is done: over the
  // stages, or in the global scratch when a restart spans column tiles
  float* D = k <= kBN ? stage : d_global + size_t(blockIdx.x) * k * kLdD;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.x * kBM;
  const int nr = min(kBM, n - row0);
  const int Ra = compact_active(active, R, act, nullptr);
  if (active != nullptr)  // a finished restart's rows get zeros
    for (int e = tid; e < R * kBM; e += kSThreads) {
      const int r = e / kBM, rr = e % kBM;
      if (rr < nr && active[r] == 0) {
        labels[size_t(r) * n + row0 + rr] = 0;
        min_d2[size_t(r) * n + row0 + rr] = 0.f;
      }
    }
  for (int rr = tid; rr < kBM; rr += kSThreads)
    xsq_s[rr] = rr < nr ? xsq[row0 + rr] : 0.f;

  const int per = max(1, kBN / k);  // restarts scored together
  const int nchunks = (m + kBK - 1) / kBK;
  for (int g0 = 0; g0 < Ra; g0 += per) {
    const int na = min(per, Ra - g0);
    const int gcols = na * k;
    for (int c0 = 0; c0 < gcols; c0 += kBN) {  // one tile unless k > kBN
      const int ncols = min(kBN, gcols - c0);
      __syncthreads();  // the last tile's stages, maps and totals are read
      for (int c = tid; c < kBN; c += kSThreads) {
        const int j = c0 + c;
        crow[c] = c < ncols ? act[g0 + j / k] * k + j % k : -1;
        if (k <= kBN) csq_s[c] = c < ncols ? csq[crow[c]] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < nchunks) {
          stage_x(stage + s * kStage, X, row0, n, m, s * kBK, vec_x);
          stage_c(stage + s * kStage + kBM * kLd, C, crow, m, s * kBK, vec_c);
        }
        cp_async_commit();
      }
      // each product is a sum of kBK-term partial sums: one m-term chain
      // errs several times more
      float tot[kTM][kTN], acc[kTM][kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) tot[i][j] = 0.f;
      for (int kc = 0; kc < nchunks; ++kc) {
        cp_async_wait<kStages - 2>();
        __syncthreads();  // chunk kc landed; chunk kc - 1 is consumed
        const int nx = kc + kStages - 1;
        if (nx < nchunks) {
          float* dst = stage + (nx % kStages) * kStage;
          stage_x(dst, X, row0, n, m, nx * kBK, vec_x);
          stage_c(dst + kBM * kLd, C, crow, m, nx * kBK, vec_c);
        }
        cp_async_commit();
        const float* xs = stage + (kc % kStages) * kStage;
        switch ((ncols + 15) / 16) {  // live column groups of 16
          case 1: chunk_products<1>(xs, tx, ty, acc); break;
          case 2: chunk_products<2>(xs, tx, ty, acc); break;
          case 3: chunk_products<3>(xs, tx, ty, acc); break;
          case 4: chunk_products<4>(xs, tx, ty, acc); break;
          case 5: chunk_products<5>(xs, tx, ty, acc); break;
          case 6: chunk_products<6>(xs, tx, ty, acc); break;
          case 7: chunk_products<7>(xs, tx, ty, acc); break;
          default: chunk_products<kTN>(xs, tx, ty, acc); break;
        }
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j)
            if (16 * j < ncols) tot[i][j] += acc[i][j];
      }
      cp_async_wait<0>();
      __syncthreads();  // every stage is consumed: D may overwrite them
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        if (tx + 16 * j < ncols)
#pragma unroll
          for (int i = 0; i < kTM; ++i)
            D[size_t(c0 + tx + 16 * j) * kLdD + ty + kRG * i] = tot[i][j];
    }
    __syncthreads();  // every total of the group is in D
    // one owner per (row, restart): the argmin, then the window pick
    for (int e = tid; e < na * kBM; e += kSThreads) {
      const int al = e / kBM, rr = e % kBM;
      if (rr >= nr) continue;
      const int r = act[g0 + al], i = row0 + rr;
      const float s = xsq_s[rr];
      // the group's norms sit in shared memory unless k > kBN
      const float* cq = k <= kBN ? csq_s + al * k : csq + size_t(r) * k;
      const float* dot = D + size_t(al) * k * kLdD + rr;
      float best = __fsub_rn(__fadd_rn(s, cq[0]), 2.0f * dot[0]);
      int lab = 0;
      for (int c = 1; c < k; ++c) {
        const float d = __fsub_rn(__fadd_rn(s, cq[c]), 2.0f * dot[c * kLdD]);
        if (d < best) {
          best = d;
          lab = c;
        }
      }
      if (gumbel != nullptr) {
        // delta-means: uniform pick inside the window, as Gumbel-argmax
        const float lim = __fadd_rn(best, window);
        const float* gi = gumbel + (size_t(r) * n + i) * k;
        float top = -INFINITY;
        for (int c0 = 0; c0 < k; c0 += 8) {
          float g[8];  // eight loads in flight, not one
#pragma unroll
          for (int q = 0; q < 8; ++q) g[q] = c0 + q < k ? gi[c0 + q] : 0.f;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int c = c0 + q;
            if (c < k) {
              const float d =
                  __fsub_rn(__fadd_rn(s, cq[c]), 2.0f * dot[c * kLdD]);
              if (d <= lim && g[q] > top) {
                top = g[q];
                lab = c;
              }
            }
          }
        }
      }
      labels[size_t(r) * n + i] = lab;
      min_d2[size_t(r) * n + i] = best;
    }
  }
}

// One fold stage: x [kFR][kJ] in X's dtype, then weights [kFR], min_d2
// and labels [R][kFR].
template <typename T>
__host__ __device__ size_t fold_stage_bytes(int R) {
  return (size_t(kFR) * kJ * sizeof(T) + (kFR + 2 * size_t(R) * kFR) * 4 +
          15) & ~size_t(15);
}

template <typename T>
size_t fold_fixed_bytes(int k, int R) {
  // the stages, w*x [kFR][kJ], runs [R][kFR], counts and inertia [R][k + 1]
  // and act [R]
  return kFStages * fold_stage_bytes<T>(R) +
         (size_t(kFR) * kJ + size_t(R) * kFR + size_t(R) * (k + 1) + R) * 4;
}

size_t fold_acc_bytes(int k, int R) { return size_t(R) * k * kJ * 4; }

// Fetch fold tile t0 (nrows rows) into a stage: x by 16-byte cp.async
// where its rows allow, else by plain loads; labels, min_d2 (first chunk
// only) and weights by 4-byte cp.async.
template <typename T>
__device__ __forceinline__ void fold_fetch(char* st, const T* X,
                                           const float* w,
                                           const int32_t* labels,
                                           const float* min_d2,
                                           const int* act, int Ra, int R,
                                           int n, int m, int col0, int ncol,
                                           int t0, int nrows, bool first,
                                           int vec) {
  T* xs = reinterpret_cast<T*>(st);
  float* ws = reinterpret_cast<float*>(st + size_t(kFR) * kJ * sizeof(T));
  float* ms = ws + kFR;
  int* ls = reinterpret_cast<int*>(ms + size_t(R) * kFR);
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  if (vec) {
    for (int v = threadIdx.x; v < kFR * kJ / kVec; v += kThreads) {
      const int rr = v / (kJ / kVec), c = (v % (kJ / kVec)) * kVec;
      const bool ok = rr < nrows && c < ncol;
      cp_async16(reinterpret_cast<float*>(xs + rr * kJ + c),
                 ok ? X + size_t(t0 + rr) * m + col0 + c : X, ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < kFR * kJ; e += kThreads) {
      const int rr = e / kJ, c = e % kJ;
      xs[e] = rr < nrows && c < ncol ? X[size_t(t0 + rr) * m + col0 + c]
                                     : T(0.f);
    }
  }
  for (int e = threadIdx.x; e < Ra * kFR; e += kThreads) {
    const int a = e / kFR, rr = e % kFR;
    if (rr < nrows) {
      const size_t at = size_t(act[a]) * n + t0 + rr;
      cp_async4(ls + e, labels + at);
      if (first) cp_async4(ms + e, min_d2 + at);
    }
  }
  if (threadIdx.x < nrows) cp_async4(ws + threadIdx.x, w + t0 + threadIdx.x);
}

// One row split's weighted partial sums of one column chunk for every
// active restart (and, for the first chunk, its counts and inertia),
// written to partial[split][active restart][sums (k, m) | counts k |
// inertia]. Tiles of 32 rows stream through a ring of kFStages cp.async
// stages. Per tile a warp sorts each restart's rows by label (stable, so
// rows stay in order within a cluster); a thread then walks the runs,
// adding w*x of its column in a register and touching each cluster's sum
// once per run.
template <typename T, bool kAccInSmem>
__global__ void __launch_bounds__(kThreads, 3)
lloyd_fold(const T* __restrict__ X, const float* __restrict__ w,
           const int32_t* __restrict__ labels,
           const float* __restrict__ min_d2,
           const int32_t* __restrict__ active, int n, int m, int k, int R,
           int rows_per_split, int vec, float* partial) {
  extern __shared__ float4 smem4[];
  char* stages = reinterpret_cast<char*>(smem4);
  const size_t sbytes = fold_stage_bytes<T>(R);
  float* xw = reinterpret_cast<float*>(stages + kFStages * sbytes);  // w*x
  // [R][kFR] label * 2048 + the row's offset in xw
  int* runs = reinterpret_cast<int*>(xw + kFR * kJ);
  float* cnt = reinterpret_cast<float*>(runs + size_t(R) * kFR);  // [R][k+1]
  int* act = reinterpret_cast<int*>(cnt + size_t(R) * (k + 1));   // [R]
  float* acc_s = reinterpret_cast<float*>(act + R);               // [R][k][kJ]

  // a warp folds a restart at a time; lane l owns columns l and l + 32
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = blockIdx.y * kJ;
  const int ncol = min(kJ, m - col0);
  const bool first = blockIdx.y == 0;  // also sums counts and inertia
  const int r0 = blockIdx.x * rows_per_split;
  const int r1 = min(n, r0 + rows_per_split);
  const int ntiles = (r1 - r0 + kFR - 1) / kFR;
  const size_t km = size_t(k) * m, P = km + k + 1;
  float* out = partial + size_t(blockIdx.x) * R * P;
  // this lane's sums of (restart a, cluster c): base[a*sa + c*sc] and 32
  // columns on, in shared memory (the compiler sees it so) or in the global
  // partials (32-bit offsets: a split's partials stay under 2^31 floats)
  float* base = kAccInSmem ? acc_s + lane : out + col0 + lane;
  const int sa = kAccInSmem ? k * kJ : int(P);
  const int sc = kAccInSmem ? kJ : m;
  const float* xwl = xw + lane;
  const bool mine0 = lane < ncol, mine1 = lane + 32 < ncol;
  const int Ra = compact_active(active, R, act, nullptr);
  for (int a = warp; a < Ra; a += kWarps)
    for (int c = 0; c < k; ++c) {
      if (mine0) base[a * sa + c * sc] = 0.f;
      if (mine1) base[a * sa + c * sc + 32] = 0.f;
    }
  for (int e = tid; e < Ra * (k + 1); e += kThreads) cnt[e] = 0.f;

#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) {
    if (s < ntiles) {
      const int t0 = r0 + s * kFR;
      fold_fetch(stages + s * sbytes, X, w, labels, min_d2, act, Ra, R, n, m,
                 col0, ncol, t0, min(kFR, r1 - t0), first, vec);
    }
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    const int t0 = r0 + t * kFR, nrows = min(kFR, r1 - t0);
    cp_async_wait<kFStages - 2>();
    __syncthreads();  // tile t landed; tile t - 1 is consumed
    const int nt = t + kFStages - 1;
    if (nt < ntiles) {
      const int t1 = r0 + nt * kFR;
      fold_fetch(stages + (nt % kFStages) * sbytes, X, w, labels, min_d2,
                 act, Ra, R, n, m, col0, ncol, t1, min(kFR, r1 - t1), first,
                 vec);
    }
    cp_async_commit();
    const char* st = stages + (t % kFStages) * sbytes;
    const T* xs = reinterpret_cast<const T*>(st);
    const float* ws =
        reinterpret_cast<const float*>(st + size_t(kFR) * kJ * sizeof(T));
    const float* ms = ws + kFR;
    const int* ls = reinterpret_cast<const int*>(ms + size_t(R) * kFR);
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {  // w*x rounded once
      const int e = tid + q * kThreads;
      xw[e] = weighted(to_f32(xs[e]), ws[e / kJ], T());
    }
    // a warp groups one restart's rows by label, in order of each label's
    // first row, rows in order within a label
    for (int a = warp; a < Ra; a += kWarps) {
      const bool ok = lane < nrows;
      const int lab = ok ? ls[a * kFR + lane] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, lab);
      const int leader = __ffs(peers) - 1;
      const int size = lane == leader ? __popc(peers) : 0;
      int incl = size;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const int start = __shfl_sync(0xffffffffu, incl - size, leader);
      const int at = start + __popc(peers & ((1u << lane) - 1u));
      if (ok) runs[a * kFR + at] = lab * 2048 + lane * kJ;
    }
    __syncthreads();
    for (int a = warp; a < Ra; a += kWarps) {
      const int* ra = runs + a * kFR;
      float* ba = base + a * sa;
      int cur = ra[0] >> 11;
      float v0 = mine0 ? ba[cur * sc] : 0.f;
      float v1 = mine1 ? ba[cur * sc + 32] : 0.f;
      int4 e4 = *reinterpret_cast<const int4*>(ra);
      for (int i0 = 0; i0 < nrows; i0 += 4) {
        // four entries and their w*x are loaded before any sum is stored:
        // the compiler cannot move loads past those stores
        const int e[4] = {e4.x, e4.y, e4.z, e4.w};
        if (i0 + 4 < nrows) e4 = *reinterpret_cast<const int4*>(ra + i0 + 4);
        float x0[4], x1[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          x0[q] = xwl[e[q] & 2047];
          x1[q] = xwl[(e[q] & 2047) + 32];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (i0 + q < nrows) {
            if ((e[q] >> 11) != cur) {
              if (mine0) ba[cur * sc] = v0;
              if (mine1) ba[cur * sc + 32] = v1;
              cur = e[q] >> 11;
              v0 = mine0 ? ba[cur * sc] : 0.f;
              v1 = mine1 ? ba[cur * sc + 32] : 0.f;
            }
            v0 += x0[q];
            v1 += x1[q];
          }
        }
      }
      if (mine0) ba[cur * sc] = v0;
      if (mine1) ba[cur * sc + 32] = v1;
    }
    if (first)
      for (int e = tid; e < Ra * (k + 1); e += kThreads) {
        const int a = e / (k + 1), c = e % (k + 1);
        const int* la = ls + a * kFR;
        float v = cnt[e];
        if (c < k) {
          for (int rr = 0; rr < nrows; ++rr)
            if (la[rr] == c) v += ws[rr];
        } else {
          const float* ma = ms + a * kFR;
          for (int rr = 0; rr < nrows; ++rr) v += __fmul_rn(ma[rr], ws[rr]);
        }
        cnt[e] = v;
      }
  }
  if (kAccInSmem)
    for (int a = warp; a < Ra; a += kWarps)
      for (int c = 0; c < k; ++c) {
        float* o = out + a * P + c * size_t(m) + col0 + lane;
        if (mine0) o[0] = base[a * sa + c * sc];
        if (mine1) o[32] = base[a * sa + c * sc + 32];
      }
  if (first)
    for (int e = tid; e < Ra * (k + 1); e += kThreads)
      out[(e / (k + 1)) * P + km + e % (k + 1)] = cnt[e];
}

// Sum each restart's split partials in split order (deterministic); an
// inactive restart gets zeros.
__global__ void lloyd_reduce(const float* __restrict__ partial,
                             const int32_t* __restrict__ active, int splits,
                             int R, int k, int m, float* sums, float* counts,
                             float* inertia) {
  extern __shared__ int places[];  // act [R], pos [R]
  const int r = blockIdx.y;
  compact_active(active, R, places, places + R);
  const int a = places[R + r];
  const size_t km = size_t(k) * m, P = km + k + 1;
  const size_t e = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= P) return;
  float s = 0.f;
  if (a >= 0) {
    const float* p = partial + size_t(a) * P + e;
    for (int b = 0; b < splits; ++b) s += p[size_t(b) * R * P];
  }
  if (e < km)
    sums[size_t(r) * km + e] = s;
  else if (e < km + k)
    counts[size_t(r) * k + (e - km)] = s;
  else
    inertia[r] = s;
}

size_t align16(size_t v) { return (v + 15) & ~size_t(15); }

size_t partial_bytes(int m, int k, int R, int splits) {
  return align16(size_t(splits) * R * (size_t(k) * m + k + 1) * 4);
}

size_t scratch_bytes(int n, int k) {
  const size_t tiles = (size_t(n) + kBM - 1) / kBM;
  return k > kBN ? tiles * k * kLdD * 4 : 0;
}

template <typename T, bool kAccInSmem>
cudaError_t launch_fold(dim3 grid, size_t bytes, cudaStream_t stream,
                        const void* X, const void* w, void* labels,
                        void* min_d2, const void* active, int n, int m, int k,
                        int R, int rows_per_split, int vec, float* partial) {
  auto* kernel = lloyd_fold<T, kAccInSmem>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(X), static_cast<const float*>(w),
      static_cast<const int32_t*>(labels), static_cast<const float*>(min_d2),
      static_cast<const int32_t*>(active), n, m, k, R, rows_per_split, vec,
      partial);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* X, const void* w, const void* xsq, const void* C,
           const void* csq, const void* gumbel, const void* active,
           float window, int n, int m, int k, int R, int splits,
           int rows_per_split, void* labels, void* min_d2, void* work,
           void* sums, void* counts, void* inertia, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t score_bytes = score_smem_bytes(R);
  // the fold's sums sit in shared memory when two blocks fit on an SM
  const size_t fixed = fold_fixed_bytes<T>(k, R);
  const int acc_in_smem = fixed + fold_acc_bytes(k, R) <= size_t(optin) / 2;
  const size_t fold_bytes = fixed + (acc_in_smem ? fold_acc_bytes(k, R) : 0);
  if (score_bytes > size_t(optin) || fold_bytes > size_t(optin))
    return cudaErrorInvalidValue;
  float* partial = static_cast<float*>(work);
  float* d_global = reinterpret_cast<float*>(
      static_cast<char*>(work) + partial_bytes(m, k, R, splits));
  const int vec_x = std::is_same<T, float>::value && m % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(X) % 16 == 0;
  const int vec_c = m % 4 == 0 && reinterpret_cast<uintptr_t>(C) % 16 == 0;
  const int vec_fold = m % (16 / sizeof(T)) == 0 &&
                       reinterpret_cast<uintptr_t>(X) % 16 == 0;

  // both kernels want the largest shared-memory carveout: two or more
  // blocks per SM
  err = cudaFuncSetAttribute(lloyd_score<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(score_bytes));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(lloyd_score<T>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  lloyd_score<T><<<(n + kBM - 1) / kBM, kSThreads, score_bytes, stream>>>(
      static_cast<const T*>(X), static_cast<const float*>(xsq),
      static_cast<const float*>(C), static_cast<const float*>(csq),
      static_cast<const float*>(gumbel), static_cast<const int32_t*>(active),
      window, n, m, k, R, vec_x, vec_c, d_global,
      static_cast<int32_t*>(labels), static_cast<float*>(min_d2));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 fold_grid(splits, (m + kJ - 1) / kJ);
  err = acc_in_smem ? launch_fold<T, true>(fold_grid, fold_bytes, stream, X,
                                           w, labels, min_d2, active, n, m,
                                           k, R, rows_per_split, vec_fold,
                                           partial)
                    : launch_fold<T, false>(fold_grid, fold_bytes, stream, X,
                                            w, labels, min_d2, active, n, m,
                                            k, R, rows_per_split, vec_fold,
                                            partial);
  if (err != cudaSuccess) return err;

  const size_t P = size_t(k) * m + k + 1;
  lloyd_reduce<<<dim3(unsigned((P + 255) / 256), R), 256,
                 2 * size_t(R) * sizeof(int), stream>>>(
      partial, static_cast<const int32_t*>(active), splits, R, k, m,
      static_cast<float*>(sums), static_cast<float*>(counts),
      static_cast<float*>(inertia));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 X, 1 = bfloat16 X. gumbel and active may be null.
// The fold cuts the rows into `splits` ranges of rows_per_split rows, a
// multiple of the fold tile; work holds sq_lloyd_workspace_bytes bytes.
int sq_lloyd_step(int dtype, const void* X, const void* w, const void* xsq,
                  const void* C, const void* csq, const void* gumbel,
                  const void* active, float window, int n, int m, int k,
                  int R, int splits, int rows_per_split, void* labels,
                  void* min_d2, void* work, void* sums, void* counts,
                  void* inertia, void* stream) {
  if (n <= 0 || m <= 0 || k <= 0 || R <= 0 || splits <= 0 ||
      rows_per_split <= 0 || rows_per_split % kFR != 0 ||
      size_t(splits) * rows_per_split < size_t(n) ||
      size_t(splits - 1) * rows_per_split >= size_t(n) || work == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(X, w, xsq, C, csq, gumbel, active, window, n, m, k,
                         R, splits, rows_per_split, labels, min_d2, work,
                         sums, counts, inertia, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(X, w, xsq, C, csq, gumbel, active, window,
                                 n, m, k, R, splits, rows_per_split, labels,
                                 min_d2, work, sums, counts, inertia, s);
  return cudaErrorInvalidValue;
}

// Bytes of the scratch buffer sq_lloyd_step needs: the splits' partials
// and, when k > 128, the scoring blocks' dot totals.
long long sq_lloyd_workspace_bytes(int n, int m, int k, int R, int splits) {
  return static_cast<long long>(partial_bytes(m, k, R, splits) +
                                scratch_bytes(n, k));
}

// The tiles the launch plan is cut to: rows a fold block stages at once
// (rows_per_split is a multiple of them) and columns a fold block owns.
void sq_lloyd_tiles(int* fold_rows, int* fold_cols) {
  *fold_rows = kFR;
  *fold_cols = kJ;
}

const char* sq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
