// Masked per-scene segment-max for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel vlsat_tpu/ops/pallas/segment_max.py
// (segment_max_pallas, body _kernel): for every scene, node n receives the
// max of edge_data[b, e, :] over the valid edges e whose
// edge_index[b, e, target] == n.  A node with no valid edge gets 0; a
// negative maximum is kept (torch-scatter semantics of
// vlsat_tpu/ops/graph.py _segment_reduce(aggr="max")).
//
// What bounds it on the H100: bytes.  It does one compare per input float,
// so the least time is one read of the valid edge rows (B*E*D*4 bytes at
// most) plus one write of the (B, N, D) output at 3.35 TB/s.
//
// Design: one block per (scene, 128-channel tile), one thread per channel.
// The scene's (N, 128) f32 accumulator (at most 64 x 128 x 4 B = 32 KB at
// the largest node bucket) and a per-node "has an edge" flag live in shared
// memory.  The block walks the scene's edges in order, 128 at a time: the
// threads first load the chunk's segment ids side by side (invalid edge ->
// -1), then every thread runs over the chunk updating acc[seg][own column].
// Each thread owns its column, so there are no atomics and no races, and
// the result is exact (max does not depend on order).  Reads of a row are
// coalesced across the block.  With only B * D/128 blocks (64 at B=32,
// D=256) the card is short of loads in flight, so each thread issues 16 row
// loads before it applies any of them.  The TPU kernel's (N, EC, D) penalty trick,
// its VMEM guard and its node-axis padding are TPU workarounds and are not
// carried over.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 128;
constexpr int kInFlight = 16;  // edge-row loads each thread keeps in flight

__global__ void segment_max_kernel(const float* __restrict__ data,        // (B, E, D)
                                   const int* __restrict__ edge_index,    // (B, E, 2)
                                   const unsigned char* __restrict__ mask,  // (B, E)
                                   float* __restrict__ out,               // (B, N, D)
                                   int E, int D, int N, int target) {
  extern __shared__ float smem[];
  float* acc = smem;                                     // (N, kTile)
  int* seen = reinterpret_cast<int*>(acc + N * kTile);   // (N,)
  int* seg = seen + N;                                   // (kTile,)

  const int b = blockIdx.x;
  const int t = threadIdx.x;
  const int col = blockIdx.y * kTile + t;
  const bool live = col < D;

  for (int i = t; i < N * kTile; i += blockDim.x) acc[i] = -INFINITY;
  for (int i = t; i < N; i += blockDim.x) seen[i] = 0;
  __syncthreads();

  const int* ei = edge_index + static_cast<size_t>(b) * E * 2 + target;
  const unsigned char* m = mask + static_cast<size_t>(b) * E;
  const float* d = data + static_cast<size_t>(b) * E * D + col;
  float* a = acc + t;

  for (int e0 = 0; e0 < E; e0 += kTile) {
    const int e = e0 + t;
    int s = -1;
    if (e < E && m[e]) {
      s = ei[2 * e];
      if (s < 0 || s >= N) {
        s = -1;  // out-of-range ids are dropped, as jax.ops.segment_max does
      } else {
        seen[s] = 1;  // every writer stores the same value
      }
    }
    seg[t] = s;
    __syncthreads();
    const int n_e = min(kTile, E - e0);
    if (live) {
      for (int j0 = 0; j0 < n_e; j0 += kInFlight) {
        // issue kInFlight independent row loads before any update, so the
        // loads' latency overlaps
        int sj[kInFlight];
        float v[kInFlight];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          sj[u] = j0 + u < n_e ? seg[j0 + u] : -1;
          v[u] = sj[u] >= 0 ? __ldg(d + static_cast<size_t>(e0 + j0 + u) * D) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          if (sj[u] >= 0) {
            float* slot = a + sj[u] * kTile;
            // v != v keeps a NaN, as torch's amax does
            if (v[u] > *slot || v[u] != v[u]) *slot = v[u];
          }
        }
      }
    }
    __syncthreads();
  }

  if (live) {
    float* o = out + static_cast<size_t>(b) * N * D + col;
    for (int n = 0; n < N; ++n) o[static_cast<size_t>(n) * D] = seen[n] ? a[n * kTile] : 0.0f;
  }
}

}  // namespace

extern "C" {

// Shared memory the kernel asks for at a given node count (bytes).
size_t segment_max_smem_bytes(int N) {
  return static_cast<size_t>(N) * kTile * sizeof(float) + static_cast<size_t>(N) * sizeof(int) +
         kTile * sizeof(int);
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
  const dim3 grid(B, (D + kTile - 1) / kTile);
  segment_max_kernel<<<grid, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const int*>(edge_index),
      static_cast<const unsigned char*>(mask), static_cast<float*>(out), E, D, N, target);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
