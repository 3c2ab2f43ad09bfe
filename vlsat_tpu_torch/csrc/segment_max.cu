// Masked per-scene segment-max for NVIDIA Hopper (sm_90a), with each
// scene's edges split over a thread-block cluster.
//
// Replaces the Pallas kernel vlsat_tpu/ops/pallas/segment_max.py
// (segment_max_pallas, body _kernel): for every scene, node n receives the
// max of edge_data[b, e, :] over the valid edges e whose
// edge_index[b, e, target] == n.  A node with no valid edge gets 0; a
// negative maximum is kept (torch-scatter semantics of
// vlsat_tpu/ops/graph.py _segment_reduce(aggr="max")); a NaN propagates,
// as torch's amax does; out-of-range ids are dropped.
//
// What bounds it on the H100: bytes.  It does one compare per input float,
// so the least time is one read of the valid edge rows (valid * D * 4
// bytes), of the indices and the mask, plus one write of the (B, N, D)
// output at 3.35 TB/s: 76 MB, 0.0227 ms, for 32 full scenes of node
// bucket 48 at D = 256.
//
// Design.  The grid is (B, D/128, S), and the S blocks of one (scene,
// 128-channel tile) form one cluster.  S is picked so that the grid holds
// about 4 blocks per SM (S = 8 at B = 32, D = 256: 512 blocks of 128
// threads), because the bytes in flight, not the compares, set the pace.
// Block r of a cluster walks the r-th contiguous slab of the scene's
// edges: the threads stage the segment ids of up to 1,024 edges side by
// side in shared memory (invalid edge -> -1), then every thread (one per
// channel) keeps two batches of 8 row loads in flight, folding one while
// the next lands.  Registers, more than loads in flight, set the pace on
// the card: at 32 loads a batch the kernel took 118 registers a thread,
// too many for every cluster of the grid to be resident at once, and ran
// 1.7x slower than at 8.  Folding keeps the max of the current run of
// edges with one segment id in a register and writes it to the thread's
// column of the block's own (N, 128) shared accumulator only when the id
// changes, so the subject-grouped order of full_edge_index costs one
// shared update per node, and any other order stays right.  A thread owns
// its column, so no atomics are needed.  After cluster.sync(), block r
// merges nodes r, r+S,
// ... by reading the S accumulators and seen-flags over distributed shared
// memory and writes them out; a second cluster.sync() keeps every block's
// shared memory alive until the others have read it.  Max does not depend
// on order, so the result is exact, with no scratch in device memory.  The
// TPU kernel's (N, EC, D) penalty trick, its VMEM guard and its node-axis
// padding are TPU workarounds and are not carried over.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 128;        // channels per block, one per thread
constexpr int kInFlight = 8;      // edge-row loads in one batch; two batches in flight
constexpr int kChunk = 1024;      // segment ids staged in shared memory at a time
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kBlocksPerSM = 4;   // the grid the cluster size aims at

// best = max(best, v), keeping a NaN once it has come
__device__ __forceinline__ void take(float& best, float v) {
  if (v > best || v != v) best = v;
}

// Row loads of edges j .. j + kInFlight - 1 of the staged chunk (0 for an
// invalid edge or past the chunk: never used).
__device__ __forceinline__ void load_rows(float (&v)[kInFlight], const float* d, const int* seg,
                                          int j, int n_e, int D) {
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) {
    const int e = j + u;
    v[u] = e < n_e && seg[e] >= 0 ? __ldg(d + static_cast<size_t>(e) * D) : 0.0f;
  }
}

// Fold the batch into the running max of the current run of edges with one
// segment id; a run is written to the shared accumulator when the id
// changes.  Edges come in runs of one id (full_edge_index groups them by
// subject), so most edges cost no shared-memory update.
__device__ __forceinline__ void fold_rows(const float (&v)[kInFlight], const int* seg, int j,
                                          int n_e, float* a, int& cur, float& run) {
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) {
    const int e = j + u;
    if (e < n_e) {
      const int s = seg[e];
      if (s == cur) {
        take(run, v[u]);
      } else {
        if (cur >= 0) take(a[cur * kTile], run);
        cur = s;  // -1: a run of invalid edges, never written
        run = v[u];
      }
    }
  }
}

__global__ void __launch_bounds__(kTile)
segment_max_kernel(const float* __restrict__ data,          // (B, E, D)
                   const int* __restrict__ edge_index,      // (B, E, 2)
                   const unsigned char* __restrict__ mask,  // (B, E)
                   float* __restrict__ out,                 // (B, N, D)
                   int E, int D, int N, int target, int slab) {
  extern __shared__ float smem[];
  float* acc = smem;                                    // (N, kTile)
  int* seen = reinterpret_cast<int*>(acc + N * kTile);  // (N,)
  int* seg = seen + N;                                  // (kChunk,)

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int S = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int col = blockIdx.y * kTile + t;
  const bool live = col < D;

  for (int i = t; i < N * kTile; i += blockDim.x) acc[i] = -INFINITY;
  for (int i = t; i < N; i += blockDim.x) seen[i] = 0;

  const int* ei = edge_index + static_cast<size_t>(b) * E * 2 + target;
  const unsigned char* m = mask + static_cast<size_t>(b) * E;
  float* a = acc + t;

  int cur = -1;               // the segment id of the current run of edges
  float run = -INFINITY;      // the max of the run so far
  const int e_end = min(E, (rank + 1) * slab);
  for (int c0 = rank * slab; c0 < e_end; c0 += kChunk) {
    const int n_e = min(kChunk, e_end - c0);
    __syncthreads();  // seg is free (and acc, seen are set, on the first pass)
    for (int i = t; i < n_e; i += blockDim.x) {
      const int e = c0 + i;
      int s = -1;
      if (m[e]) {
        s = ei[2 * e];
        if (s < 0 || s >= N) {
          s = -1;  // out-of-range ids are dropped, as jax.ops.segment_max does
        } else {
          seen[s] = 1;  // every writer stores the same value
        }
      }
      seg[i] = s;
    }
    __syncthreads();
    if (live) {
      // two batches of row loads in flight: one is folded while the next lands
      const float* d = data + (static_cast<size_t>(b) * E + c0) * D + col;
      float va[kInFlight], vb[kInFlight];
      load_rows(va, d, seg, 0, n_e, D);
      for (int j = 0; j < n_e; j += 2 * kInFlight) {
        load_rows(vb, d, seg, j + kInFlight, n_e, D);
        fold_rows(va, seg, j, n_e, a, cur, run);
        load_rows(va, d, seg, j + 2 * kInFlight, n_e, D);
        fold_rows(vb, seg, j + kInFlight, n_e, a, cur, run);
      }
    }
  }
  if (live && cur >= 0) take(a[cur * kTile], run);

  cluster.sync();  // every slab of the scene is folded into its block's accumulator
  if (live) {
    float* o = out + static_cast<size_t>(b) * N * D + col;
    for (int n = rank; n < N; n += S) {
      float best = -INFINITY;
      bool any = false;
      for (int r = 0; r < S; ++r) {
        if (cluster.map_shared_rank(seen, r)[n]) {
          any = true;
          take(best, cluster.map_shared_rank(acc, r)[n * kTile + t]);
        }
      }
      o[static_cast<size_t>(n) * D] = any ? best : 0.0f;
    }
  }
  cluster.sync();  // no block exits while another still reads its shared memory
}

}  // namespace

extern "C" {

// Shared memory the kernel asks for at a given node count (bytes).
size_t segment_max_smem_bytes(int N) {
  return static_cast<size_t>(N) * kTile * sizeof(float) + static_cast<size_t>(N) * sizeof(int) +
         kChunk * sizeof(int);
}

// Blocks per (scene, channel tile): about kBlocksPerSM blocks per SM in
// all, at most the portable cluster size.
int segment_max_cluster_size(int B, int D) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 1;
  const long long tiles = static_cast<long long>(B) * ((D + kTile - 1) / kTile);
  const long long s = (static_cast<long long>(kBlocksPerSM) * sms + tiles - 1) / tiles;
  return s < 1 ? 1 : (s > kMaxCluster ? kMaxCluster : static_cast<int>(s));
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
int segment_max_f32(const void* data, const void* edge_index, const void* mask, void* out, int B,
                    int E, int D, int N, int target, void* stream) {
  if (B == 0 || N == 0 || D == 0) return 0;
  const size_t smem = segment_max_smem_bytes(N);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        segment_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int S = segment_max_cluster_size(B, D);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B, (D + kTile - 1) / kTile, S);
  cfg.blockDim = dim3(kTile);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = S;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, segment_max_kernel, static_cast<const float*>(data),
      static_cast<const int*>(edge_index), static_cast<const unsigned char*>(mask),
      static_cast<float*>(out), E, D, N, target, (E + S - 1) / S);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
