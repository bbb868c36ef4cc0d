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
// R=10 restarts, float32): the function needs 2*n*m*k*R + 2*n*m*R = 12.07 G
// f32 operations (distance products, then the weighted sums), 0.18 ms at
// 67 TFLOP/s outside the tensor cores, and moves 254 MB if X is read once
// (0.08 ms at 3.35 TB/s): bound by operations. This design reads X once
// per restart, R*n*m*4 B = 2.195 GB, 0.66 ms, so its own floor is set by
// bytes. It does nothing about that yet (a later kernel reads X once for
// all restarts and feeds the products to the tensor cores); it keeps the
// work simple and right:
//  - one block owns a fixed row range of one restart and walks it in tiles
//    of kTileRows rows. Phase A scores one row per warp against the centers
//    held in shared memory (coalesced 16-byte loads of x, warp-shuffle
//    reductions). Phase B folds the tile into the block's partial sums:
//    thread t owns columns j = t (mod blockDim) of every cluster, and counts
//    and inertia have one owner each, so every partial is summed in row
//    order by one thread;
//  - a second kernel sums the block partials in block order. There are no
//    float atomics: sums, counts and inertia are bit-identical from run to
//    run;
//  - an optional `active` (R) mask makes every block of a finished restart
//    exit at once, after writing zeros for its rows' labels and distances
//    (the reduction writes zeros for its sums, counts and inertia), so the
//    caller need not clear the outputs.
//
// Precision: the f32 path is f32 FMA throughout (no TF32, no tensor cores).
// The bf16 path loads X in bf16 and accumulates in f32; the centers arrive
// as f32 values already rounded to bf16, and the weighted rows w*x are
// rounded once to bf16 before they are summed, as the TPU kernel does.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o liblloyd.so lloyd.cu
// The C entry point returns a cudaError_t code (0 on success); it launches
// on the given stream and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 16;     // centers scored per pass over a row
constexpr int kTileRows = 32;  // rows scored before phase B folds them

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// four consecutive elements as floats; the caller guarantees alignment
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// w*x rounded once into the GEMM dtype (identity for f32)
__device__ __forceinline__ float weighted(float x, float w, float) {
  return __fmul_rn(x, w);
}
__device__ __forceinline__ float weighted(float x, float w, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(x, w)));
}

__host__ __device__ __forceinline__ size_t align4(size_t v) { return (v + 3) & ~size_t(3); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
lloyd_partials(const T* __restrict__ X, const float* __restrict__ w,
               const float* __restrict__ xsq, const float* __restrict__ C,
               const float* __restrict__ csq, const float* __restrict__ gumbel,
               const int32_t* __restrict__ active, float window, int n, int m,
               int k, int rows_per_block, int c_in_smem, int acc_in_smem,
               int vec, int32_t* labels, float* min_d2, float* partial) {
  const int r = blockIdx.y;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * rows_per_block;
  const int row1 = min(n, row0 + rows_per_block);
  if (active != nullptr && active[r] == 0) {
    // a finished restart: its rows get zeros, and nothing is scored
    for (int i = row0 + tid; i < row1; i += kThreads) {
      labels[size_t(r) * n + i] = 0;
      min_d2[size_t(r) * n + i] = 0.f;
    }
    return;
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t km = size_t(k) * m;
  const size_t P = km + k + 1;  // sums, counts, inertia
  float* out = partial + (size_t(r) * gridDim.x + blockIdx.x) * P;

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* d2_s = smem;  // kWarps x k: one row's distances per warp
  size_t off = align4(size_t(kWarps) * k);
  const float* Cr = C + size_t(r) * km;
  float* C_s = smem + off;
  if (c_in_smem) off += align4(km);
  float* acc = acc_in_smem ? smem + off : out;

  if (c_in_smem)
    for (size_t e = tid; e < km; e += kThreads) C_s[e] = Cr[e];
  const float* Cb = c_in_smem ? C_s : Cr;
  // every thread zeroes exactly the partials it will own
  for (int j = tid; j < m; j += kThreads)
    for (int c = 0; c < k; ++c) acc[size_t(c) * m + j] = 0.f;
  for (int c = tid; c < k; c += kThreads) acc[km + c] = 0.f;
  if (tid == 0) acc[km + k] = 0.f;
  __syncthreads();

  const float* csq_r = csq + size_t(r) * k;
  const float* gum_r = gumbel != nullptr ? gumbel + size_t(r) * n * k : nullptr;
  int32_t* lab_r = labels + size_t(r) * n;
  float* mind_r = min_d2 + size_t(r) * n;
  float* d2w = d2_s + warp * k;

  for (int t0 = row0; t0 < row1; t0 += kTileRows) {
    const int t1 = min(row1, t0 + kTileRows);
    // phase A: one warp scores one row against every center
    for (int i = t0 + warp; i < t1; i += kWarps) {
      const T* x = X + size_t(i) * m;
      const float s = xsq[i];
      for (int g = 0; g < k; g += kGroup) {
        float dot[kGroup];
#pragma unroll
        for (int c = 0; c < kGroup; ++c) dot[c] = 0.f;
        if (vec) {
          for (int j = lane * 4; j < m; j += 128) {
            const float4 xv = load4(x + j);
#pragma unroll
            for (int c = 0; c < kGroup; ++c) {
              if (g + c < k) {
                const float4 cv = *reinterpret_cast<const float4*>(
                    Cb + size_t(g + c) * m + j);
                dot[c] = fmaf(xv.x, cv.x, dot[c]);
                dot[c] = fmaf(xv.y, cv.y, dot[c]);
                dot[c] = fmaf(xv.z, cv.z, dot[c]);
                dot[c] = fmaf(xv.w, cv.w, dot[c]);
              }
            }
          }
        } else {
          for (int j = lane; j < m; j += 32) {
            const float xv = to_f32(x[j]);
#pragma unroll
            for (int c = 0; c < kGroup; ++c)
              if (g + c < k) dot[c] = fmaf(xv, Cb[size_t(g + c) * m + j], dot[c]);
          }
        }
#pragma unroll
        for (int c = 0; c < kGroup; ++c) {
          float v = dot[c];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
          if (lane == 0 && g + c < k)
            d2w[g + c] = __fsub_rn(__fadd_rn(s, csq_r[g + c]), 2.0f * v);
        }
      }
      __syncwarp();
      if (lane == 0) {
        float best = d2w[0];
        int lab = 0;
        for (int c = 1; c < k; ++c)
          if (d2w[c] < best) { best = d2w[c]; lab = c; }
        if (gum_r != nullptr) {
          // delta-means: uniform pick inside the window, as Gumbel-argmax
          const float lim = __fadd_rn(best, window);
          const float* gi = gum_r + size_t(i) * k;
          float top = -INFINITY;
          for (int c = 0; c < k; ++c)
            if (d2w[c] <= lim && gi[c] > top) { top = gi[c]; lab = c; }
        }
        lab_r[i] = lab;
        mind_r[i] = best;
      }
      __syncwarp();  // d2w is reused by this warp's next row
    }
    __syncthreads();  // the tile's labels are visible to the whole block
    // phase B: fold the tile into the partials, rows in order
    for (int j = tid; j < m; j += kThreads) {
      for (int i = t0; i < t1; ++i) {
        float* a = acc + size_t(lab_r[i]) * m + j;
        *a += weighted(to_f32(X[size_t(i) * m + j]), w[i], T());
      }
    }
    for (int c = tid; c < k; c += kThreads) {
      float cnt = acc[km + c];
      for (int i = t0; i < t1; ++i)
        if (lab_r[i] == c) cnt += w[i];
      acc[km + c] = cnt;
    }
    if (tid == kThreads - 1) {
      float in = acc[km + k];
      for (int i = t0; i < t1; ++i) in += __fmul_rn(mind_r[i], w[i]);
      acc[km + k] = in;
    }
  }
  if (acc_in_smem) {
    __syncthreads();
    for (size_t e = tid; e < P; e += kThreads) out[e] = acc[e];
  }
}

// Sum the block partials of each restart in block order (deterministic).
__global__ void lloyd_reduce(const float* __restrict__ partial,
                             const int32_t* __restrict__ active, int nblocks,
                             int k, int m, float* sums, float* counts,
                             float* inertia) {
  const int r = blockIdx.y;
  const size_t km = size_t(k) * m;
  const size_t P = km + k + 1;
  const size_t e = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= P) return;
  float s = 0.f;  // a finished restart's partials were not written: zeros
  if (active == nullptr || active[r] != 0) {
    const float* p = partial + size_t(r) * nblocks * P + e;
    for (int b = 0; b < nblocks; ++b) s += p[size_t(b) * P];
  }
  if (e < km)
    sums[size_t(r) * km + e] = s;
  else if (e < km + k)
    counts[size_t(r) * k + (e - km)] = s;
  else
    inertia[r] = s;
}

template <typename T>
int launch(const void* X, const void* w, const void* xsq, const void* C,
           const void* csq, const void* gumbel, const void* active,
           float window, int n, int m, int k, int R, int nblocks,
           int rows_per_block, void* labels, void* min_d2, void* partial,
           void* sums, void* counts, void* inertia, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  // leave room for two resident blocks per SM where the arrays allow it
  const size_t budget = size_t(optin) / 2;
  const size_t km = size_t(k) * m;
  size_t bytes = align4(size_t(kWarps) * k) * sizeof(float);
  if (bytes > size_t(optin)) return cudaErrorInvalidValue;
  int c_in_smem = 0, acc_in_smem = 0;
  if (bytes + align4(km) * sizeof(float) <= budget) {
    c_in_smem = 1;
    bytes += align4(km) * sizeof(float);
  }
  if (bytes + (km + k + 1) * sizeof(float) <= budget) {
    acc_in_smem = 1;
    bytes += (km + k + 1) * sizeof(float);
  }
  const int vec = (m % 4 == 0) &&
                  reinterpret_cast<uintptr_t>(X) % (4 * sizeof(T)) == 0 &&
                  reinterpret_cast<uintptr_t>(C) % 16 == 0;
  err = cudaFuncSetAttribute(lloyd_partials<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(bytes));
  if (err != cudaSuccess) return err;
  lloyd_partials<T><<<dim3(nblocks, R), kThreads, bytes, stream>>>(
      static_cast<const T*>(X), static_cast<const float*>(w),
      static_cast<const float*>(xsq), static_cast<const float*>(C),
      static_cast<const float*>(csq), static_cast<const float*>(gumbel),
      static_cast<const int32_t*>(active), window, n, m, k, rows_per_block,
      c_in_smem, acc_in_smem, vec, static_cast<int32_t*>(labels),
      static_cast<float*>(min_d2), static_cast<float*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t P = km + k + 1;
  lloyd_reduce<<<dim3(unsigned((P + 255) / 256), R), 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<const int32_t*>(active),
      nblocks, k, m, static_cast<float*>(sums), static_cast<float*>(counts),
      static_cast<float*>(inertia));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32 X, 1 = bfloat16 X. gumbel and active may be null.
int sq_lloyd_step(int dtype, const void* X, const void* w, const void* xsq,
                  const void* C, const void* csq, const void* gumbel,
                  const void* active, float window, int n, int m, int k,
                  int R, int nblocks, int rows_per_block, void* labels,
                  void* min_d2, void* partial, void* sums, void* counts,
                  void* inertia, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(X, w, xsq, C, csq, gumbel, active, window, n, m, k,
                         R, nblocks, rows_per_block, labels, min_d2, partial,
                         sums, counts, inertia, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(X, w, xsq, C, csq, gumbel, active, window,
                                 n, m, k, R, nblocks, rows_per_block, labels,
                                 min_d2, partial, sums, counts, inertia, s);
  return cudaErrorInvalidValue;
}

const char* sq_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
