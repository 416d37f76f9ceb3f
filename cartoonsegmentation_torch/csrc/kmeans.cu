// K12a: k-means labels of the CRF's colour guide (Lloyd's algorithm).
//
// Replaces cartoonsegmentation_tpu/ops/crf.py:_kmeans_labels (:55-74):
// N points of 3 channels, k clusters (10 in the CRF), 8 iterations of
// assign + recentre, then a final assignment. The init is the points
// arange(k) * (N / k); the first minimum wins a tie (jnp.argmin); a
// cluster that gets no point keeps its centre.
//
// Bound on the card (chip_smoke.py's kmeans_cost): operations. The
// colours read once and the labels written once are 16 B a point
// (9.4 MB at 576 x 1024, 2.8 us at 3.35 TB/s); the arithmetic is ~9
// f32 operations a point and cluster in each of the 9 assignments and
// 4 a point in each of the 8 recentrings (0.50 G, 7.4 us at 67
// TFLOP/s). The CRF clip's crops are small (16x176 to 419x101 px), so
// there a call is latency: the 9 passes and 8 exchanges of the
// clusters' sums, one after another.
//
// Design: one launch a call. Each block owns a run of `per` points
// and reads their colours once into shared memory (x, y and z apart),
// where they stay for all 9 passes; the centres sit in every thread's
// registers for a pass. A pass: each thread assigns its points, two at
// a time (the label into shared memory; the last pass writes it out),
// then warp c sums cluster c's points of the block: lane l its points
// l, l + 32, ... in order, 8 loaded at once (another cluster's point
// is multiplied by 0: it adds a zero), then a fixed xor tree over the
// lanes (the count in integers). The blocks exchange their partials (k x (sum x, y, z,
// count)) and every block adds them itself in the same fixed order,
// so every block holds the same new centres: thread (q, v) adds value
// v of blocks q, q + 8, q + 16, ... in order, all its loads in flight
// at once, and thread c adds the 8 sums of each of cluster c's values
// in order. No atomics: two calls give the same bits. Two kinds of
// launch (ops/crf.py: kmeans_plan):
// - up to KMEANS_CLUSTER_POINTS points (every crop of the CRF clip):
//   one thread-block cluster of up to 16 blocks (the non-portable
//   size; fewer where the card cannot hold a cluster of 16 such
//   blocks, as cudaOccupancyMaxPotentialClusterSize tells: another
//   part, a MIG slice, a shared card), the partials in each block's
//   shared memory, ping-pong, read by the others through distributed
//   shared memory after one cluster barrier an iteration;
// - more points: one cooperative launch of a block an SM (all
//   resident), the partials in the caller's scratch, ping-pong, one
//   grid barrier an iteration. A block whose run exceeds kTile points
//   reads it again from global memory in tiles in every pass.
// The sums round otherwise than the plain version's one-hot matmul,
// so a point near a tie between two centres may take the other label
// (the tests hold >= 99.9% of labels equal).
#include <cooperative_groups.h>

#include "kb_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;       // KMEANS_THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 16;           // KMEANS_MAX_K (<= kWarps)
constexpr int kTile = 8192;         // KMEANS_TILE: points a block keeps
constexpr int kMaxCluster = 16;     // KMEANS_CLUSTER_BLOCKS
constexpr int kGroups = kThreads / (kMaxK * 4);   // 8: the exchange's
                                                  // first-level sums
constexpr int kMaxRows = 20;        // blocks a first-level sum loads at once
constexpr int kUnroll = 8;          // points a lane loads at once in a sum
constexpr unsigned kAll = 0xffffffffu;

// Nearest of the k centres, strict < so the first minimum wins. The
// squared distance is fma(d2, d2, fma(d1, d1, d0 d0)): XLA's CPU code
// contracts the JAX version's sum of squares so, and exact ties
// between centres are common on flat colours. KC: k known at compile
// time (the CRF's 10), or 0 for any k <= kMaxK (each centre then
// behind a test of k).
template <int KC>
__device__ __forceinline__ int nearest(float x, float y, float z,
                                       const float* cx, const float* cy,
                                       const float* cz, int k) {
  int best = 0;
  float bd = INFINITY;
#pragma unroll
  for (int c = 0; c < (KC ? KC : kMaxK); ++c) {
    if (KC || c < k) {
      const float d0 = x - cx[c], d1 = y - cy[c], d2 = z - cz[c];
      const float d = __fmaf_rn(d2, d2, __fmaf_rn(d1, d1, d0 * d0));
      if (d < bd) {
        bd = d;
        best = c;
      }
    }
  }
  return best;
}

__device__ __forceinline__ float xor_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

// kCoop: the cooperative launch (partials in `scratch`), else one
// cluster (partials in shared memory); KC as in nearest. Block b owns points
// [b·per, min((b+1)·per, N)); `tile` points of them fit its shared
// memory.
template <bool kCoop, int KC>
__global__ void __launch_bounds__(kThreads, 1)
    kmeans_kernel(const float* __restrict__ colors, int N, int k, int iters,
                  int per, int tile, float* __restrict__ scratch,
                  int* __restrict__ labels) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ys = xs + tile;
  float* zs = ys + tile;
  unsigned char* lb = reinterpret_cast<unsigned char*>(zs + tile);
  __shared__ float cs[kMaxK * 3];
  __shared__ float part[2][kMaxK * 4];      // the block's partials
  __shared__ float sub[kGroups][kMaxK * 4]; // the exchange's first level
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = gridDim.x, rank = blockIdx.x;
  const long long start = (long long)rank * per;
  const int n = (int)max(0LL, min((long long)per, (long long)N - start));
  const bool resident = per <= tile;
  if (tid < 3 * k) {
    const long long i = (long long)(tid / 3) * (N / k);
    cs[tid] = colors[i * 3 + tid % 3];
  }
  __syncthreads();
  for (int it = 0;; ++it) {
    const bool last = it == iters;
    float cx[kMaxK], cy[kMaxK], cz[kMaxK];
#pragma unroll
    for (int c = 0; c < (KC ? KC : kMaxK); ++c) {
      if (KC || c < k) {
        cx[c] = cs[c * 3];
        cy[c] = cs[c * 3 + 1];
        cz[c] = cs[c * 3 + 2];
      }
    }
    // warp `warp`'s cluster: this lane's sums
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;
    int cnt = 0;
    for (int t0 = 0; t0 < n; t0 += tile) {
      const int tn = min(tile, n - t0);
      if (!resident || it == 0) {
        __syncthreads();     // the last tile's pass is done with it
        const float* src = colors + (start + t0) * 3;
        for (int j = tid; j < tn; j += kThreads) {
          xs[j] = __ldg(src + 3 * j);
          ys[j] = __ldg(src + 3 * j + 1);
          zs[j] = __ldg(src + 3 * j + 2);
        }
        __syncthreads();
      }
      // two points a thread at a time, where it has two: their chains
      // interleave
      for (int j = tid; j < tn; j += 2 * kThreads) {
        const int j2 = j + kThreads;
        int l, l2 = 0;
        if (j2 < tn) {
          l = nearest<KC>(xs[j], ys[j], zs[j], cx, cy, cz, k);
          l2 = nearest<KC>(xs[j2], ys[j2], zs[j2], cx, cy, cz, k);
        } else {
          l = nearest<KC>(xs[j], ys[j], zs[j], cx, cy, cz, k);
        }
        if (last) {
          labels[start + t0 + j] = l;
          if (j2 < tn) labels[start + t0 + j2] = l2;
        } else {
          lb[j] = (unsigned char)l;
          if (j2 < tn) lb[j2] = (unsigned char)l2;
        }
      }
      if (last) continue;
      __syncthreads();
      if (warp < k) {
        // kUnroll of this lane's points loaded at once, whatever their
        // label (a load under the label's test would wait for it);
        // another cluster's point is multiplied by 0 and adds a zero,
        // which leaves a sum that started at +0.0 as it is
        for (int j0 = lane; j0 < tn; j0 += 32 * kUnroll) {
          float vx[kUnroll], vy[kUnroll], vz[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int jj = min(j0 + 32 * u, tn - 1);
            const bool m = j0 + 32 * u < tn && lb[jj] == warp;
            const float f = m ? 1.0f : 0.0f;
            vx[u] = xs[jj] * f;
            vy[u] = ys[jj] * f;
            vz[u] = zs[jj] * f;
            cnt += m;
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            sx += vx[u];
            sy += vy[u];
            sz += vz[u];
          }
        }
      }
    }
    if (last) break;
    // the block's partial of cluster `warp`
    float* mine;
    if constexpr (kCoop)
      mine = scratch + ((long long)(it & 1) * nb + rank) * (kMaxK * 4);
    else
      mine = part[it & 1];
    if (warp < k) {
      sx = xor_sum(sx);
      sy = xor_sum(sy);
      sz = xor_sum(sz);
      cnt = __reduce_add_sync(kAll, cnt);
      if (lane == 0) {
        mine[warp * 4] = sx;
        mine[warp * 4 + 1] = sy;
        mine[warp * 4 + 2] = sz;
        mine[warp * 4 + 3] = (float)cnt;
      }
    }
    // every block adds every block's partials, in the same order:
    // thread (q, v) the blocks q, q + kGroups, ... of value v in order
    // (their loads all in flight), then thread c < k the kGroups sums
    // of cluster c's 4 values in order
    const int q = tid / (kMaxK * 4), v = tid % (kMaxK * 4);
    float a = 0.0f;
    if constexpr (kCoop) {
      cg::this_grid().sync();
      const float* all = scratch + (long long)(it & 1) * nb * (kMaxK * 4);
      if (v < 4 * k) {
        float got[kMaxRows];
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          const int b = q + r * kGroups;
          got[r] = b < nb ? __ldcg(all + (long long)b * (kMaxK * 4) + v)
                          : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) a += got[r];
        for (int b = q + kMaxRows * kGroups; b < nb; b += kGroups)
          a += __ldcg(all + (long long)b * (kMaxK * 4) + v);
      }
    } else {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      if (v < 4 * k) {
        // at most 16 blocks: two a first-level sum
        const int b2 = q + kGroups;
        const float a0 = q < nb ? cluster.map_shared_rank(part[it & 1], q)[v]
                                : 0.0f;
        const float a1 = b2 < nb
                             ? cluster.map_shared_rank(part[it & 1], b2)[v]
                             : 0.0f;
        a += a0;
        a += a1;
      }
    }
    if (v < 4 * k) sub[q][v] = a;
    __syncthreads();
    if (tid < k) {
      float t[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        t[j] = 0.0f;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) t[j] += sub[g][tid * 4 + j];
      }
      if (t[3] > 0.0f) {
        const float c = fmaxf(t[3], 1.0f);
        cs[tid * 3] = t[0] / c;
        cs[tid * 3 + 1] = t[1] / c;
        cs[tid * 3 + 2] = t[2] / c;
      }
    }
    __syncthreads();
  }
  // no block leaves while another may still read its partials
  if constexpr (!kCoop) cg::this_cluster().sync();
}

size_t smem_bytes(int tile) {
  return ((size_t)tile * 13 + 15) / 16 * 16;
}

// kernel K's attributes, set once a device; the blocks a device holds
// at once of the cooperative kernel, and the largest cluster it can
// schedule of the cluster kernel (both at the most shared memory a
// block takes)
template <int KC>
cudaError_t prepare(int dev, int* resident, int* cluster) {
  static int held[64] = {0};
  static int widest[64] = {0};
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (held[dev] == 0) {
    const int most = (int)smem_bytes(kTile);
    cudaError_t e = cudaFuncSetAttribute(
        kmeans_kernel<false, KC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kmeans_kernel<false, KC>,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(
          kmeans_kernel<true, KC>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    int per_sm = 0, sms = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kmeans_kernel<true, KC>, kThreads, most);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    int most_blocks = 0;
    if (e == cudaSuccess) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(kMaxCluster);
      cfg.blockDim = dim3(kThreads);
      cfg.dynamicSmemBytes = most;
      e = cudaOccupancyMaxPotentialClusterSize(
          &most_blocks, kmeans_kernel<false, KC>, &cfg);
    }
    if (e != cudaSuccess) return e;
    if (per_sm * sms < 1 || most_blocks < 1) return cudaErrorNotSupported;
    held[dev] = per_sm * sms;
    widest[dev] = most_blocks < kMaxCluster ? most_blocks : kMaxCluster;
  }
  *resident = held[dev];
  *cluster = widest[dev];
  return cudaSuccess;
}

template <int KC>
cudaError_t launch(const float* colors, int N, int k, int iters, int blocks,
                   bool cooperative, float* scratch, int* labels,
                   cudaStream_t s) {
  int dev = 0, resident = 0, cluster = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = prepare<KC>(dev, &resident, &cluster);
  if (e != cudaSuccess) return e;
  const int most = cooperative ? resident : cluster;
  const int grid = blocks > most ? most : blocks;
  const int per = (int)(((long long)N + grid - 1) / grid);
  const int tile = per < kTile ? per : kTile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(tile);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  if (cooperative) {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
  } else {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)grid;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
  }
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cooperative
             ? cudaLaunchKernelEx(&cfg, kmeans_kernel<true, KC>, colors, N, k,
                                  iters, per, tile, scratch, labels)
             : cudaLaunchKernelEx(&cfg, kmeans_kernel<false, KC>, colors, N,
                                  k, iters, per, tile, scratch, labels);
}

}  // namespace

// colors: (N, 3) f32; 1 <= k <= 16; blocks, cooperative: the launch of
// ops/crf.py:kmeans_plan (a cluster of 1 to 16 blocks, or a
// cooperative grid), which the kernel caps at the largest cluster, or
// the resident blocks, the card can hold; scratch: 2 * blocks * 64 f32 for a cooperative launch (else
// unused); labels: (N,) int32 out. Returns the launch's error.
extern "C" int kb_kmeans(const float* colors, int N, int k, int iters,
                         int blocks, int cooperative, float* scratch,
                         int* labels, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > kMaxK || iters < 0 || blocks < 1 ||
      (!cooperative && blocks > kMaxCluster))
    return (int)cudaErrorInvalidValue;
  // the CRF's 10 clusters compiled in, any other k tested at run time
  return (int)(k == 10 ? launch<10>(colors, N, k, iters, blocks,
                                    cooperative != 0, scratch, labels, s)
                       : launch<0>(colors, N, k, iters, blocks,
                                   cooperative != 0, scratch, labels, s));
}
