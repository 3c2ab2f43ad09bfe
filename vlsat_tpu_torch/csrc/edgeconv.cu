// One EdgeConv stage of the DGCNN in factored form, after the projection:
// neighbour gather, eval BatchNorm, LeakyReLU 0.2 and the max over the k
// neighbours in one pass, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package (vlsat_tpu/models/sggpoint.py,
// DGCNN) and the port's training path build the EdgeConv input
// [x_j - x_i, x_i] as a (..., P, k, 2 C_in) tensor, project it, normalise
// it and max it over k, each a pass over a k-wide tensor (5.4 GB at bucket
// 64).  The 1x1 convolution of [x_j - x_i, x_i] by W = [W1 | W2] is
// (x_j - x_i) W1^T + x_i W2^T = (u_j - u_i) + w_i with u = x W1^T and
// w = x W2^T, so the port projects every point once (one fp32 product by
// W viewed as (2 C_out, C_in), which puts u_c at column 2c and w_c at
// column 2c + 1 of each point's row) and this kernel does the rest:
//
//   out[i, c] = max over j in idx[i] of LeakyReLU_0.2(
//       (((u[j, c] - u[i, c]) + w[i, c]) - mean[c]) / sqrt(var[c] + eps)
//       * gamma[c] + beta[c])
//
// in MaskedBatchNorm's order, each step rounded on its own (no FMA
// contraction), so that given the same projection it gives the plain
// twin's bits.  An index outside [0, P) gives NaN at its point; a NaN
// propagates through the max, as torch's amax does.
//
// What bounds it on the H100: bytes and the k divisions of every output.
// One read of the projection (M P 2C floats) and of the indices (M P k
// int64) and one write of the (M, P, C) output at 3.35 TB/s: 0.53 ms for
// the four stages of a bucket-64 batch (2,048 instances, P 128, k 20),
// where the dense form writes and reads tensors of up to 5.4 GB some eight
// times.  The IEEE division (a reciprocal, two Newton steps and a range
// check) is the costliest instruction of the k-fold inner loop.
//
// Design.  One block per (instance, 64-channel tile), 256 threads.  The
// block stages the instance's P x k indices (as int32) and the P x 64 u
// tile in shared memory (10 KB + 32 KB at P = 128, k = 20).  Thread t owns
// four channels (t % 16) of points t / 16, t / 16 + 16, ...: it reads the
// point's own u and w for them in two 16-byte loads, walks the k
// neighbours in their order with 16-byte shared loads of their u, and
// writes its four outputs in one 16-byte store, so every global access is
// coalesced along channels.  The order over j is fixed and nothing is
// shared between instances (no atomics), so an instance's output has the
// same bits whatever batch it is in.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 64;                  // channels per block
constexpr int kQuads = kTile / 4;          // threads per point: four channels each
constexpr int kThreads = 256;
constexpr int kRows = kThreads / kQuads;   // points a block works on at once

// best = max(best, v), keeping a NaN once it has come
__device__ __forceinline__ void take(float& best, float v) {
  if (v > best || v != v) best = v;
}

// One neighbour's value of one channel, rounded step by step in the order
// of the dense path: the projection sum, then MaskedBatchNorm's eval
// expression, then LeakyReLU (x > 0 ? x : x * 0.2).
__device__ __forceinline__ float edge_value(float uj, float ui, float wi, float mean, float sd,
                                            float gamma, float beta) {
  const float h = __fadd_rn(__fsub_rn(uj, ui), wi);
  const float y = __fadd_rn(__fmul_rn(__fdiv_rn(__fsub_rn(h, mean), sd), gamma), beta);
  return y > 0.0f ? y : __fmul_rn(y, 0.2f);
}

__global__ void __launch_bounds__(kThreads)
edgeconv_max_kernel(const float* __restrict__ uw,         // (M, P, 2C): u_c at 2c, w_c at 2c+1
                    const long long* __restrict__ idx,    // (M, P, k)
                    const float* __restrict__ mean, const float* __restrict__ var,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    float* __restrict__ out,              // (M, P, C)
                    int P, int k, int C, float eps) {
  extern __shared__ __align__(16) float smem[];
  float* us = smem;                                    // (P, kTile): the tile's u
  int* nb = reinterpret_cast<int*>(us + P * kTile);    // (P, k): the neighbours

  const int m = blockIdx.x;
  const int c0 = blockIdx.y * kTile;
  const int width = min(kTile, C - c0);                // a multiple of 4
  const float* src = uw + static_cast<size_t>(m) * P * 2 * C;

  const long long* id = idx + static_cast<size_t>(m) * P * k;
  for (int t = threadIdx.x; t < P * k; t += kThreads) {
    const long long j = id[t];
    nb[t] = j >= 0 && j < P ? static_cast<int>(j) : -1;
  }
  const int pairs = width / 2;  // one 16-byte load holds (u, w) of two channels
  for (int t = threadIdx.x; t < P * pairs; t += kThreads) {
    const int p = t / pairs, q = t - p * pairs;
    const float4 v = *reinterpret_cast<const float4*>(
        src + static_cast<size_t>(p) * 2 * C + 2 * c0 + 4 * q);
    *reinterpret_cast<float2*>(us + p * kTile + 2 * q) = make_float2(v.x, v.z);
  }
  __syncthreads();

  const int c = 4 * (threadIdx.x % kQuads);  // the thread's channels, in the tile
  if (c >= width) return;                    // no barrier follows
  float mu[4], sd[4], g[4], b[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int ch = c0 + c + r;
    mu[r] = mean[ch];
    sd[r] = __fsqrt_rn(__fadd_rn(var[ch], eps));
    g[r] = gamma[ch];
    b[r] = beta[ch];
  }
  const float4 poison = make_float4(NAN, NAN, NAN, NAN);
  for (int i = threadIdx.x / kQuads; i < P; i += kRows) {
    const float* row = src + static_cast<size_t>(i) * 2 * C + 2 * (c0 + c);
    const float4 lo = *reinterpret_cast<const float4*>(row);      // u0 w0 u1 w1
    const float4 hi = *reinterpret_cast<const float4*>(row + 4);  // u2 w2 u3 w3
    float best[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    const int* nbi = nb + i * k;
#pragma unroll 4
    for (int s = 0; s < k; ++s) {
      const int j = nbi[s];
      const float4 uj = j >= 0 ? *reinterpret_cast<const float4*>(us + j * kTile + c) : poison;
      take(best[0], edge_value(uj.x, lo.x, lo.y, mu[0], sd[0], g[0], b[0]));
      take(best[1], edge_value(uj.y, lo.z, lo.w, mu[1], sd[1], g[1], b[1]));
      take(best[2], edge_value(uj.z, hi.x, hi.y, mu[2], sd[2], g[2], b[2]));
      take(best[3], edge_value(uj.w, hi.z, hi.w, mu[3], sd[3], g[3], b[3]));
    }
    *reinterpret_cast<float4*>(out + (static_cast<size_t>(m) * P + i) * C + c0 + c) =
        make_float4(best[0], best[1], best[2], best[3]);
  }
}

}  // namespace

extern "C" {

// Shared memory the kernel asks for at P points and k neighbours (bytes).
size_t edgeconv_smem_bytes(int P, int k) {
  return static_cast<size_t>(P) * kTile * sizeof(float) + static_cast<size_t>(P) * k * sizeof(int);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// C must be a multiple of 4 and every pointer 16-byte aligned (the wrapper
// checks both).
int edgeconv_max_f32(const void* uw, const void* idx, const void* mean, const void* var,
                     const void* gamma, const void* beta, void* out, int M, int P, int k, int C,
                     float eps, void* stream) {
  if (M == 0 || P == 0 || C == 0) return 0;
  const size_t smem = edgeconv_smem_bytes(P, k);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        edgeconv_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(M, (C + kTile - 1) / kTile);
  edgeconv_max_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(uw), static_cast<const long long*>(idx),
      static_cast<const float*>(mean), static_cast<const float*>(var),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<float*>(out), P, k, C, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
