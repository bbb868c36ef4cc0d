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
// 31.4 MB; 0.066 ms at 3.35 TB/s): bound by operations. The products stay
// on CUDA cores in exact f32 (no TF32, no tensor cores), so what the design
// does about the bound is keep the FMA pipes fed:
//  - short lists (k <= kShortK, the k-NN path), `argkmin_short`: a block
//    owns kBQ = 128 queries and one split of the train rows, and walks the
//    split in tiles of kBT = 128 rows. The (query x train) score tile is a
//    register-tiled f32 product, as `lloyd_score` computes it: 16 x 16
//    threads each hold 8 queries x 8 train rows, so per 4 columns a thread
//    makes 16 16-byte shared-memory loads for 256 FMAs. Both operands are
//    staged kBK columns at a time through a cp.async ring that runs on
//    across tile boundaries, so the next tile's first chunks are in flight
//    while a tile is folded. A thread's copies of a later chunk are started
//    one per 4 columns inside the product loop, from source pointers set
//    once per chunk: started in one burst per chunk they took a fifth of
//    the warps' cycles. A tile's train norms are loaded at its first chunk
//    and read at its fold. Each score is one FMA chain over ascending
//    columns, the arithmetic of the first design (`argkmin_partial` below),
//    so the two give the same bits. A 128-query tile re-reads each train
//    tile 79 times at the predict shape (14.9 GB from L2), where 32-query
//    tiles re-read it 313 times;
//  - the fold is spread over every thread and needs no barrier: the 16
//    lanes of a half-warp hold the 128 scores of a query, and slot e of the
//    query's k-best (score, index) list in shared memory belongs to lane e.
//    Each lane compares its scores with the list's k-th entry; where any
//    score in the warp beats it, the half-warp extracts the survivors in
//    (score, index) order (a shuffle min) and inserts each by a one-slot
//    shift (a shuffle up). The k best under that total order are unique,
//    so the result does not depend on the order of arrival. Once the lists
//    fill, almost nothing survives and a tile costs one compare per score;
//  - long lists (k > kShortK), `argkmin_partial`, the first design: a block
//    owns kTileQ = 32 queries, each thread a 4 x 4 register tile fed from
//    synchronously staged 32-column chunks; each query's list has one
//    owner thread that folds the tile's scores in ascending train index
//    with strict `<`. The lists sit in shared memory when they fit beside
//    the tiles in half of the opt-in limit, else in the global partial
//    buffer the wrapper allocates: one code path with a pointer;
//  - both write one partial list per (split, query); `argkmin_merge`
//    merges each query's S lists in split order, comparing (score, index)
//    lexicographically, and writes the epilogue. There are no atomics: two
//    launches are bit-identical.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libargkmin.so argkmin.cu
// The C entry point returns a cudaError_t code (0 on success); it launches
// on the given stream and does not synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // 8 warps, both routes
constexpr int kNoIndex = 0x7fffffff;    // an empty list slot sorts last
constexpr unsigned kFull = 0xffffffffu;

// short lists: a kBQ x kBT score tile, 16 x 16 threads of kTQ x kTT each
constexpr int kShortK = 16;   // one list slot per lane of a half-warp
constexpr int kTQ = 8;        // queries a thread scores
constexpr int kTT = 8;        // train rows a thread scores
constexpr int kBQ = 16 * kTQ;  // queries a block owns
constexpr int kBT = 16 * kTT;  // train rows per tile
constexpr int kBK = 32;        // columns staged per chunk
constexpr int kLd = kBK + 4;   // stage row stride: 16-byte rows, float4
                               // reads free of bank conflicts
constexpr int kStages = 3;     // cp.async ring depth
constexpr int kStage = (kBQ + kBT) * kLd;  // floats in one stage
constexpr int kVecRow = kBK / 4;               // 16-byte pieces of a row
constexpr int kRowStep = kThreads / kVecRow;   // rows between a thread's
                                               // pieces
constexpr int kCopies = kBQ / kRowStep;        // pieces a thread copies
                                               // per operand and chunk
static_assert(2 * kCopies == kBK / 4,
              "one copy per 4-column step of the products");
constexpr int kShortBlocks = 1;            // resident blocks the launch
                                           // bounds ask for
constexpr size_t kShortBytes =
    (size_t(kStages) * kStage + size_t(kBQ) * kShortK * 2) * 4;

// long lists: the first design
constexpr int kTileQ = 32;              // queries a block owns (4 per warp)
constexpr int kTileT = 128;             // train rows per tile (4 per lane)
constexpr int kChunk = 32;              // feature columns staged per pass
constexpr int kPad = kChunk + 4;        // tile row stride: 16-byte rows
constexpr int kSPad = kTileT + 1;       // score tile row stride
static_assert(kBT == kTileT, "both routes cut splits into the same tiles");

constexpr size_t kTileFloats =
    size_t(kTileQ) * kPad + size_t(kTileT) * kPad + size_t(kTileQ) * kSPad;

size_t list_bytes(int k) {
  return size_t(kTileQ) * k * (sizeof(float) + sizeof(int32_t));
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// (as, ai) ranks before (bs, bi): the total order of the lists
__device__ __forceinline__ bool before(float as, int ai, float bs, int bi) {
  return as < bs || (as == bs && ai < bi);
}

// Stage 128 rows of A from row0, columns [c0, c0 + kBK), into dst (stride
// kLd) by plain loads, for rows that are not 16-byte aligned; rows from
// `end` on and columns beyond m are zeros.
__device__ __forceinline__ void stage_rows(float* dst, const float* A,
                                           int row0, int end, int m,
                                           int c0) {
  static_assert(kBQ == kBT, "one staging routine for both operands");
  for (int e = threadIdx.x; e < kBQ * kBK; e += kThreads) {
    const int r = e / kBK, c = e % kBK;
    const int i = row0 + r, j = c0 + c;
    dst[r * kLd + c] = (i < end && j < m) ? A[size_t(i) * m + j] : 0.f;
  }
}

// The products of one staged chunk, added to acc: acc[i][j] is the product
// of query ty + 16 i with train row tx + 16 j, one FMA chain over ascending
// columns. copy(s) starts the thread's s-th copy of a later chunk: spread
// one per 4 columns, the copies do not stall the loop in a burst.
template <typename Copy>
__device__ __forceinline__ void chunk_products(const float* qs,
                                               const float* ts, int tx,
                                               int ty,
                                               float (&acc)[kTQ][kTT],
                                               const Copy& copy) {
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 4) {
    copy(kk / 4);
    float4 qa[kTQ];
#pragma unroll
    for (int i = 0; i < kTQ; ++i)
      qa[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kLd + kk);
#pragma unroll
    for (int j = 0; j < kTT; ++j) {
      const float4 tv =
          *reinterpret_cast<const float4*>(ts + (tx + 16 * j) * kLd + kk);
#pragma unroll
      for (int i = 0; i < kTQ; ++i) {
        acc[i][j] = fmaf(qa[i].x, tv.x, acc[i][j]);
        acc[i][j] = fmaf(qa[i].y, tv.y, acc[i][j]);
        acc[i][j] = fmaf(qa[i].z, tv.z, acc[i][j]);
        acc[i][j] = fmaf(qa[i].w, tv.w, acc[i][j]);
      }
    }
  }
}

// Fold one tile of products (train rows from t0, real below r1, their
// norms in tq) into the block's lists; turns acc into scores. The
// half-warp of lanes with this ty owns queries ty + 16 i; lane tx owns slot
// tx of their lists.
__device__ __forceinline__ void fold_tile(float (&acc)[kTQ][kTT],
                                          const float (&tq)[kTT], int t0,
                                          int r1, int k, int tx, int ty,
                                          float* ls, int32_t* li) {
  const int lane = threadIdx.x & 31;
  const int kth = (lane & 16) | (k - 1);  // lane holding this half's k-th
#pragma unroll
  for (int i = 0; i < kTQ; ++i) {
    float* L = ls + (ty + 16 * i) * kShortK;
    int32_t* Li = li + (ty + 16 * i) * kShortK;
    float ws = L[k - 1];
    int wi = Li[k - 1];
    unsigned alive = 0;  // bit j: row tx + 16 j ranks before the k-th
#pragma unroll
    for (int j = 0; j < kTT; ++j) {
      const int r = t0 + tx + 16 * j;
      acc[i][j] = __fsub_rn(tq[j], 2.0f * acc[i][j]);
      if (r < r1 && before(acc[i][j], r, ws, wi)) alive |= 1u << j;
    }
    if (!__any_sync(kFull, alive)) continue;
    float es = L[tx];
    int ei = Li[tx];
    while (__any_sync(kFull, alive)) {
      // the half-warp's least survivor, by (score, index)
      float ms = INFINITY;
      int mi = kNoIndex;
#pragma unroll
      for (int j = 0; j < kTT; ++j)
        if ((alive >> j & 1u) && before(acc[i][j], t0 + tx + 16 * j, ms, mi)) {
          ms = acc[i][j];
          mi = t0 + tx + 16 * j;
        }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float os = __shfl_xor_sync(kFull, ms, off);
        const int oi = __shfl_xor_sync(kFull, mi, off);
        if (before(os, oi, ms, mi)) {
          ms = os;
          mi = oi;
        }
      }
      // insert it: the slots from its place on shift up by one
      const float ps = __shfl_up_sync(kFull, es, 1, 16);
      const int pi = __shfl_up_sync(kFull, ei, 1, 16);
      if (mi != kNoIndex && !before(es, ei, ms, mi)) {
        if (tx == 0 || before(ps, pi, ms, mi)) {
          es = ms;
          ei = mi;
        } else {
          es = ps;
          ei = pi;
        }
      }
      ws = __shfl_sync(kFull, es, kth);
      wi = __shfl_sync(kFull, ei, kth);
#pragma unroll
      for (int j = 0; j < kTT; ++j) {
        const int r = t0 + tx + 16 * j;
        if (r == mi || !before(acc[i][j], r, ws, wi)) alive &= ~(1u << j);
      }
    }
    L[tx] = es;
    Li[tx] = ei;
  }
}

// Scores of kBQ queries against one split of the train rows, folded into
// their k-best lists (k <= kShortK); writes the lists to the partial
// buffer, laid out [split][query][k].
__global__ void __launch_bounds__(kThreads, kShortBlocks)
argkmin_short(const float* __restrict__ T, const float* __restrict__ tsq,
              const float* __restrict__ Q, int nt, int nq, int m, int k,
              int rows_per_split, int vec, float* __restrict__ part_d,
              int32_t* __restrict__ part_i) {
  extern __shared__ float4 smem4[];
  float* stage = reinterpret_cast<float*>(smem4);  // [kStages][kBQ + kBT][kLd]
  float* ls = stage + kStages * kStage;            // [kBQ][kShortK]
  int32_t* li = reinterpret_cast<int32_t*>(ls + kBQ * kShortK);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * kBQ;
  const int split = blockIdx.y;
  const int r0 = split * rows_per_split;
  const int r1 = min(nt, r0 + rows_per_split);
  const int nchunks = (m + kBK - 1) / kBK;
  const int total = (r1 - r0 + kBT - 1) / kBT * nchunks;  // (tile, chunk)s

  // every slot is read and written by its own half-warp only
#pragma unroll
  for (int i = 0; i < kTQ; ++i) {
    ls[(ty + 16 * i) * kShortK + tx] = INFINITY;
    li[(ty + 16 * i) * kShortK + tx] = kNoIndex;
  }
  // Chunk g of the split's (tile, chunk) walk is staged by 16-byte
  // cp.async where the rows are aligned: each thread copies kCopies pieces
  // of each operand, rows crow + n kRowStep, columns ccol..ccol + 3. aim(g)
  // points the copies at chunk g; copy(s) starts the s-th.
  const int crow = tid / kVecRow, ccol = (tid % kVecRow) * 4;
  const size_t step = size_t(kRowStep) * m;
  const float* qsrc = Q + (size_t(q0) + crow) * m + ccol;
  unsigned qrows = 0;  // bit n: query row crow + n kRowStep is real
#pragma unroll
  for (int n = 0; n < kCopies; ++n)
    if (q0 + crow + n * kRowStep < nq) qrows |= 1u << n;
  float* dst = stage;
  const float* tsrc = T;
  unsigned qok = 0, tok = 0;
  int c0 = 0;
  auto aim = [&](int g) {
    dst = stage + (g % kStages) * kStage;
    c0 = (g % nchunks) * kBK;
    const int t0 = r0 + g / nchunks * kBT;
    tsrc = T + (size_t(t0) + crow) * m + ccol;
    const bool col_ok = c0 + ccol < m;
    qok = col_ok ? qrows : 0u;
    tok = 0;
#pragma unroll
    for (int n = 0; n < kCopies; ++n)
      if (col_ok && t0 + crow + n * kRowStep < r1) tok |= 1u << n;
  };
  auto copy = [&](int s) {
    if (s < kCopies) {
      const bool ok = qok >> s & 1u;
      cp_async16(dst + (crow + s * kRowStep) * kLd + ccol,
                 ok ? qsrc + s * step + c0 : Q, ok ? 16 : 0);
    } else {
      const int n = s - kCopies;
      const bool ok = tok >> n & 1u;
      cp_async16(dst + (kBQ + crow + n * kRowStep) * kLd + ccol,
                 ok ? tsrc + n * step + c0 : T, ok ? 16 : 0);
    }
  };
  auto fetch_plain = [&](int g) {  // rows not 16-byte aligned
    float* d = stage + (g % kStages) * kStage;
    const int c = (g % nchunks) * kBK;
    stage_rows(d, Q, q0, nq, m, c);
    stage_rows(d + kBQ * kLd, T, r0 + g / nchunks * kBT, r1, m, c);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total) {
      if (vec) {
        aim(s);
#pragma unroll
        for (int c = 0; c < 2 * kCopies; ++c) copy(c);
      } else {
        fetch_plain(s);
      }
    }
    cp_async_commit();
  }
  float acc[kTQ][kTT], tq[kTT];
#pragma unroll
  for (int i = 0; i < kTQ; ++i)
#pragma unroll
    for (int j = 0; j < kTT; ++j) acc[i][j] = 0.f;
  for (int g = 0; g < total; ++g) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk g landed; chunk g - 1 is consumed
    const int ahead = g + kStages - 1;  // the chunk staged meanwhile
    const bool vec_ahead = vec && ahead < total;
    if (vec_ahead)
      aim(ahead);
    else if (ahead < total)
      fetch_plain(ahead);
    const int t0 = r0 + g / nchunks * kBT;
    if (g % nchunks == 0)  // the tile's norms, read by its fold
#pragma unroll
      for (int j = 0; j < kTT; ++j) {
        const int r = t0 + tx + 16 * j;
        tq[j] = r < r1 ? tsq[r] : 0.f;
      }
    const float* qs = stage + (g % kStages) * kStage;
    chunk_products(qs, qs + kBQ * kLd, tx, ty, acc, [&](int s) {
      if (vec_ahead) copy(s);
    });
    cp_async_commit();
    if (g % nchunks == nchunks - 1) {  // the tile is done: fold it
      fold_tile(acc, tq, t0, r1, k, tx, ty, ls, li);
#pragma unroll
      for (int i = 0; i < kTQ; ++i)
#pragma unroll
        for (int j = 0; j < kTT; ++j) acc[i][j] = 0.f;
    }
  }
  cp_async_wait<0>();
  if (tx < k)
#pragma unroll
    for (int i = 0; i < kTQ; ++i) {
      const int q = q0 + ty + 16 * i;
      if (q < nq) {
        const size_t off = (size_t(split) * nq + q) * k + tx;
        part_d[off] = ls[(ty + 16 * i) * kShortK + tx];
        part_i[off] = li[(ty + 16 * i) * kShortK + tx];
      }
    }
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

// The routes, by k: what sq_argkmin_route reports.
constexpr int kRouteShort = 0;       // argkmin_short
constexpr int kRouteLongShared = 1;  // argkmin_partial, lists in shared
constexpr int kRouteLongGlobal = 2;  // argkmin_partial, lists in global

// The route k takes on the current device and its kernel's dynamic shared
// memory; sets the kernel's opt-in size and largest carveout.
int route_of(int k, int* route, const void** fn, size_t* bytes) {
  if (k <= kShortK) {
    *route = kRouteShort;
    *fn = reinterpret_cast<const void*>(argkmin_short);
    *bytes = kShortBytes;
  } else {
    int in_smem = 0;
    const int err = lists_in_smem(k, &in_smem, bytes);
    if (err != cudaSuccess) return err;
    *route = in_smem ? kRouteLongShared : kRouteLongGlobal;
    *fn = reinterpret_cast<const void*>(argkmin_partial);
  }
  cudaError_t err = cudaFuncSetAttribute(
      *fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(*bytes));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(*fn,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

extern "C" {

// T (nt, m), tsq (nt), Q (nq, m) float32; part_d/part_i hold
// splits * nq * k entries; buf_d/buf_i 2 * nq * k (may be null when
// splits == 1); out_i (nq, k) int32, out_d (nq, k) float32. The splits of
// rows_per_split rows (a multiple of the tile) cover the nt rows, each
// split at least one row.
int sq_argkmin(const void* T, const void* tsq, const void* Q, int nt, int nq,
               int m, int k, int splits, int rows_per_split, void* part_d,
               void* part_i, void* buf_d, void* buf_i, void* out_i,
               void* out_d, void* stream) {
  if (nq <= 0 || nt <= 0 || m <= 0 || k <= 0 || k > nt || splits <= 0 ||
      rows_per_split <= 0 || rows_per_split % kTileT != 0 ||
      size_t(splits) * rows_per_split < size_t(nt) ||
      size_t(splits - 1) * rows_per_split >= size_t(nt) ||
      (splits > 1 && (buf_d == nullptr || buf_i == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int route = 0;
  const void* fn = nullptr;
  size_t bytes = 0;
  int err = route_of(k, &route, &fn, &bytes);
  if (err != cudaSuccess) return err;
  if (route == kRouteShort) {
    const int vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(T) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(Q) % 16 == 0;
    argkmin_short<<<dim3((nq + kBQ - 1) / kBQ, splits), kThreads, bytes, s>>>(
        static_cast<const float*>(T), static_cast<const float*>(tsq),
        static_cast<const float*>(Q), nt, nq, m, k, rows_per_split, vec,
        static_cast<float*>(part_d), static_cast<int32_t*>(part_i));
  } else {
    argkmin_partial<<<dim3((nq + kTileQ - 1) / kTileQ, splits), kThreads,
                      bytes, s>>>(
        static_cast<const float*>(T), static_cast<const float*>(tsq),
        static_cast<const float*>(Q), nt, nq, m, k, rows_per_split,
        route == kRouteLongShared, static_cast<float*>(part_d),
        static_cast<int32_t*>(part_i));
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  argkmin_merge<<<(nq + 127) / 128, 128, 0, s>>>(
      static_cast<const float*>(Q), nq, m, k, splits,
      static_cast<const float*>(part_d), static_cast<const int32_t*>(part_i),
      static_cast<float*>(buf_d), static_cast<int32_t*>(buf_i),
      static_cast<int32_t*>(out_i), static_cast<float*>(out_d));
  return cudaGetLastError();
}

// The route k takes on the current device: 0 short lists (argkmin_short,
// k <= kShortK), 1 long lists in shared memory, 2 long lists in the global
// partial buffer (argkmin_partial); a negative cudaError_t on failure.
int sq_argkmin_route(int k) {
  int route = 0;
  const void* fn = nullptr;
  size_t bytes = 0;
  const int err = route_of(k, &route, &fn, &bytes);
  return err != cudaSuccess ? -err : route;
}

// What the launch plan of k's route is cut to: queries a block owns, train
// rows per tile (rows_per_split is a multiple of them) and the blocks of
// that kernel resident on one SM of the current device. Returns a
// cudaError_t.
int sq_argkmin_tiles(int k, int* tile_q, int* tile_t, int* resident) {
  int route = 0;
  const void* fn = nullptr;
  size_t bytes = 0;
  cudaError_t err = static_cast<cudaError_t>(route_of(k, &route, &fn, &bytes));
  if (err != cudaSuccess) return err;
  *tile_q = route == kRouteShort ? kBQ : kTileQ;
  *tile_t = kTileT;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, fn, kThreads,
                                                       bytes);
}

const char* sq_argkmin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
