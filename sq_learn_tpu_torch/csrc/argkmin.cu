// Fused k-nearest search for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `argkmin_pallas` (sq_learn_tpu/ops/pallas_kernels.py:305,
// tile body `_make_argkmin_kernel`). For each query q it returns the k
// training rows of smallest score ||t||^2 - 2 q.t (f32 accumulation),
// ascending, ties to the lowest training index (the lax.top_k rule the TPU
// kernel keeps), then d2 = max(score + ||q||^2, 0).
//
// Bound on an H100 SXM at the k-NN slice's predict shape (nq=10000 queries,
// nt=60000 training rows, m=784, k=7, float32): 2*nq*nt*m = 940.8 G f32
// operations, 14.04 ms at 67 TFLOP/s outside the tensor cores, against
// about 220 MB moved if every input is read once (train 188.2 MB, queries
// 31.4 MB; 0.066 ms at 3.35 TB/s): bound by operations. This first design
// keeps the products on CUDA cores in f32 (no TF32, no tensor cores) and
// re-reads each train tile once per query tile (from L2 mostly: the blocks
// resident together share a split of the train rows). What it does about
// the operation bound: each thread keeps a 4 x 4 register tile of scores,
// fed by 16-byte shared-memory loads, so a block does 16 FMAs per pair of
// vector loads. Making it fast (wgmma on a TF32 or bf16 shortlist with an
// exact re-rank, TMA) is later work:
//  - a block owns kTileQ queries and a contiguous range of training rows
//    (one split of S); it walks its range in tiles of kTileT rows, staging
//    the query and train tiles in shared memory kChunk columns at a time,
//    so any width works;
//  - each query's running k-best (score, index) list has one owner thread,
//    which folds a tile's scores in ascending train index and inserts with
//    strict `<`: an equal score lands after the entries already held, whose
//    indices are lower. The lists sit in shared memory when they fit
//    beside the tiles in half of the opt-in limit, else in the global
//    partial buffer the wrapper allocates: one code path with a pointer;
//  - a second kernel merges each query's S partial lists in split order,
//    comparing (score, index) lexicographically, and writes the epilogue.
//    There are no atomics: two launches are bit-identical.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libargkmin.so argkmin.cu
// The C entry point returns a cudaError_t code (0 on success); it launches
// on the given stream and does not synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // 8 warps
constexpr int kTileQ = 32;              // queries a block owns (4 per warp)
constexpr int kTileT = 128;             // train rows per tile (4 per lane)
constexpr int kChunk = 32;              // feature columns staged per pass
constexpr int kPad = kChunk + 4;        // tile row stride: 16-byte rows
constexpr int kSPad = kTileT + 1;       // score tile row stride
constexpr int kNoIndex = 0x7fffffff;    // an empty list slot sorts last

constexpr size_t kTileFloats =
    size_t(kTileQ) * kPad + size_t(kTileT) * kPad + size_t(kTileQ) * kSPad;

size_t list_bytes(int k) {
  return size_t(kTileQ) * k * (sizeof(float) + sizeof(int32_t));
}

// Scores of one query tile against one split of the train rows, folded into
// the tile's k-best lists; writes the lists to the partial buffer, laid out
// [split][query][k].
__global__ void __launch_bounds__(kThreads)
argkmin_partial(const float* __restrict__ T, const float* __restrict__ tsq,
                const float* __restrict__ Q, int nt, int nq, int m, int k,
                int rows_per_split, int lists_in_smem,
                float* __restrict__ part_d, int32_t* __restrict__ part_i) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = blockIdx.x * kTileQ;
  const int split = blockIdx.y;
  const int r0 = split * rows_per_split;
  const int r1 = min(nt, r0 + rows_per_split);

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ts = Qs + kTileQ * kPad;
  float* Sc = Ts + kTileT * kPad;
  float* lists = Sc + kTileQ * kSPad;

  // lane qi of warp 0 owns query q0 + qi
  const bool owner = warp == 0 && q0 + lane < nq;
  const size_t out_off = (size_t(split) * nq + q0 + lane) * k;
  float* my_d = nullptr;
  int32_t* my_i = nullptr;
  if (owner) {
    if (lists_in_smem) {
      my_d = lists + size_t(lane) * k;
      my_i = reinterpret_cast<int32_t*>(lists + size_t(kTileQ) * k) +
             size_t(lane) * k;
    } else {
      my_d = part_d + out_off;
      my_i = part_i + out_off;
    }
    for (int e = 0; e < k; ++e) {
      my_d[e] = INFINITY;
      my_i[e] = kNoIndex;
    }
  }

  for (int t0 = r0; t0 < r1; t0 += kTileT) {
    const int nrows = min(kTileT, r1 - t0);
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

    for (int c0 = 0; c0 < m; c0 += kChunk) {
      // stage the chunk; a warp reads 32 consecutive columns of one row
      for (int e = tid; e < kTileQ * kChunk; e += kThreads) {
        const int r = e / kChunk, c = e % kChunk;
        const int col = c0 + c;
        Qs[r * kPad + c] =
            (q0 + r < nq && col < m) ? Q[size_t(q0 + r) * m + col] : 0.f;
      }
      for (int e = tid; e < kTileT * kChunk; e += kThreads) {
        const int r = e / kChunk, c = e % kChunk;
        const int col = c0 + c;
        Ts[r * kPad + c] =
            (r < nrows && col < m) ? T[size_t(t0 + r) * m + col] : 0.f;
      }
      __syncthreads();
      // warp w scores queries 4w..4w+3 against rows lane + 32b, columns in
      // ascending order (one FMA chain per score)
#pragma unroll
      for (int c = 0; c < kChunk; c += 4) {
        float4 qv[4], tv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
          qv[a] = *reinterpret_cast<const float4*>(Qs + (warp * 4 + a) * kPad + c);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          tv[b] = *reinterpret_cast<const float4*>(Ts + (lane + 32 * b) * kPad + c);
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            acc[a][b] = fmaf(qv[a].x, tv[b].x, acc[a][b]);
            acc[a][b] = fmaf(qv[a].y, tv[b].y, acc[a][b]);
            acc[a][b] = fmaf(qv[a].z, tv[b].z, acc[a][b]);
            acc[a][b] = fmaf(qv[a].w, tv[b].w, acc[a][b]);
          }
      }
      __syncthreads();  // the tiles are restaged by the next chunk
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = lane + 32 * b;
        Sc[(warp * 4 + a) * kSPad + r] =
            r < nrows ? __fsub_rn(tsq[t0 + r], 2.0f * acc[a][b]) : INFINITY;
      }
    __syncthreads();
    if (owner) {
      // fold the tile in ascending train index; strict < keeps the lower
      // index first among equal scores
      const float* srow = Sc + lane * kSPad;
      float worst = my_d[k - 1];
      for (int r = 0; r < nrows; ++r) {
        const float v = srow[r];
        if (v < worst) {
          int p = k - 1;
          while (p > 0 && my_d[p - 1] > v) {
            my_d[p] = my_d[p - 1];
            my_i[p] = my_i[p - 1];
            --p;
          }
          my_d[p] = v;
          my_i[p] = t0 + r;
          worst = my_d[k - 1];
        }
      }
    }
    // Sc is next written after the next tile's chunk loop, whose
    // __syncthreads the owners reach only once their fold is done
  }
  if (owner && lists_in_smem) {
    for (int e = 0; e < k; ++e) {
      part_d[out_off + e] = my_d[e];
      part_i[out_off + e] = my_i[e];
    }
  }
}

// One thread per query: merge the S partial lists in split order (every
// index of split s is below every index of split s+1, so (score, index)
// order is score order with ties to the lower index), then add ||q||^2 and
// clamp at 0.
__global__ void argkmin_merge(const float* __restrict__ Q, int nq, int m,
                              int k, int splits,
                              const float* __restrict__ part_d,
                              const int32_t* __restrict__ part_i,
                              float* __restrict__ buf_d,
                              int32_t* __restrict__ buf_i,
                              int32_t* __restrict__ out_i,
                              float* __restrict__ out_d) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  const size_t plane = size_t(nq) * k;
  const size_t kq = size_t(q) * k;
  const float* cd = part_d + kq;
  const int32_t* ci = part_i + kq;
  for (int s = 1; s < splits; ++s) {
    const float* ld = part_d + s * plane + kq;
    const int32_t* li = part_i + s * plane + kq;
    float* od = buf_d + (s & 1) * plane + kq;
    int32_t* oi = buf_i + (s & 1) * plane + kq;
    int a = 0, b = 0;  // a + b == e < k: neither list runs out
    for (int e = 0; e < k; ++e) {
      const bool take_new =
          ld[b] < cd[a] || (ld[b] == cd[a] && li[b] < ci[a]);
      if (take_new) {
        od[e] = ld[b];
        oi[e] = li[b];
        ++b;
      } else {
        od[e] = cd[a];
        oi[e] = ci[a];
        ++a;
      }
    }
    cd = od;
    ci = oi;
  }
  const float* x = Q + size_t(q) * m;
  float qsq = 0.f;
  for (int c = 0; c < m; ++c) qsq = fmaf(x[c], x[c], qsq);
  for (int e = 0; e < k; ++e) {
    out_i[kq + e] = ci[e];
    out_d[kq + e] = fmaxf(__fadd_rn(cd[e], qsq), 0.f);
  }
}

int lists_in_smem(int k, int* in_smem, size_t* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  const size_t tiles = kTileFloats * sizeof(float);
  // leave room for two resident blocks per SM
  *in_smem = tiles + list_bytes(k) <= size_t(optin) / 2;
  *bytes = tiles + (*in_smem ? list_bytes(k) : 0);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// T (nt, m), tsq (nt), Q (nq, m) float32; part_d/part_i hold
// splits * nq * k entries; buf_d/buf_i 2 * nq * k (may be null when
// splits == 1); out_i (nq, k) int32, out_d (nq, k) float32.
int sq_argkmin(const void* T, const void* tsq, const void* Q, int nt, int nq,
               int m, int k, int splits, int rows_per_split, void* part_d,
               void* part_i, void* buf_d, void* buf_i, void* out_i,
               void* out_d, void* stream) {
  if (nq <= 0 || nt <= 0 || m <= 0 || k <= 0 || k > nt || splits <= 0 ||
      rows_per_split <= 0 || rows_per_split % kTileT != 0 ||
      (splits > 1 && (buf_d == nullptr || buf_i == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int in_smem = 0;
  size_t bytes = 0;
  int err = lists_in_smem(k, &in_smem, &bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(argkmin_partial,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(bytes));
  if (err != cudaSuccess) return err;
  const int qtiles = (nq + kTileQ - 1) / kTileQ;
  argkmin_partial<<<dim3(qtiles, splits), kThreads, bytes, s>>>(
      static_cast<const float*>(T), static_cast<const float*>(tsq),
      static_cast<const float*>(Q), nt, nq, m, k, rows_per_split, in_smem,
      static_cast<float*>(part_d), static_cast<int32_t*>(part_i));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  argkmin_merge<<<(nq + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(Q), nq, m, k, splits,
      static_cast<const float*>(part_d), static_cast<const int32_t*>(part_i),
      static_cast<float*>(buf_d), static_cast<int32_t*>(buf_i),
      static_cast<int32_t*>(out_i), static_cast<float*>(out_d));
  return cudaGetLastError();
}

// 1 when the k-best lists of a block sit in shared memory, 0 when they sit
// in the global partial buffer, a negative cudaError_t on failure.
int sq_argkmin_lists_in_shared(int k) {
  int in_smem = 0;
  size_t bytes = 0;
  const int err = lists_in_smem(k, &in_smem, &bytes);
  return err != cudaSuccess ? -err : in_smem;
}

// The tiles the launch plan must be cut to: queries a block owns and train
// rows per tile (rows_per_split is a multiple of the latter).
void sq_argkmin_tiles(int* tile_q, int* tile_t) {
  *tile_q = kTileQ;
  *tile_t = kTileT;
}

const char* sq_argkmin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
