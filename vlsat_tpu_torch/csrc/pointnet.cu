// Fused three-layer PointNet encoder for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernels in vlsat_tpu/ops/pallas/pointnet_kernel.py:
// pointnet_encode_fused (body _kernel) and, through the p_chunk argument,
// pointnet_encode_fused_v2 (body _kernel_chunked).  Per instance m:
//
//     out[m] = max_p relu(relu(relu(x[m,p]@W1+b1)@W2+b2)@W3+b3)
//
// without writing the (M, P, 768) activation to device memory.
//
// What bounds it on the H100: operations.  At the object encoder's widths
// (3->64->128->768, P=128) it does 2*P*(3*64+64*128+128*768) = 27.3 MFLOP
// per instance against ~1.5 KB of points in and 3 KB out, far above the
// card's fp32 ops-per-byte ridge.  The work is full fp32 FMA on the CUDA
// cores (no TF32), so the bound is the 67 TFLOP/s fp32 rate.
//
// Design: one block (256 threads) per instance.  The instance's points are
// staged in shared memory transposed, (C, chunk), and layers 1 and 2 write
// their activations to shared memory in the same (features, points) layout:
// at P=128 that is 32 KB + 64 KB, above the 48 KB static limit, so the
// dynamic size is requested with cudaFuncSetAttribute.  Every layer is the
// same loop: a thread owns one output channel and a tile of PT points held
// in registers; for each input feature k it reads W[k][channel] (coalesced
// across the warp) and PT activations (one broadcast float4 per 4 points)
// and does PT FMAs.  Layer 3 never stores its output: each thread folds
// relu(acc + b3) into a running max for its channels.  With p_chunk < P the
// block walks the points in p_chunk slabs and folds each slab into the same
// running max: that is the point-major chunking of the v2 Pallas kernel, and
// it shrinks shared memory to (C + H1 + H2) * p_chunk floats.  A slab is
// padded to a multiple of PT with copies of its first point, which leaves
// the max unchanged.  wgmma/TMA pipelining is left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// out_t[n][p] = relu(sum_k in_t[k][p] * W[k][n] + b[n]) for p < cpad, or,
// with POOL, pool[n] = max(pool[n], max_p relu(...)).
template <int PT, bool POOL>
__device__ __forceinline__ void dense_relu(const float* __restrict__ in_t, int K, int cpad,
                                           const float* __restrict__ W,
                                           const float* __restrict__ bias, int N,
                                           float* __restrict__ dst) {
  const int tiles = cpad / PT;
  // POOL: a thread owns a channel for all tiles (no two threads share a
  // pool slot).  Otherwise work items are (channel, tile) pairs.
  const int items = POOL ? N : N * tiles;
  for (int w = threadIdx.x; w < items; w += blockDim.x) {
    const int n = w % N;
    const int t0 = POOL ? 0 : w / N;
    const int t1 = POOL ? tiles : t0 + 1;
    const float bn = bias[n];
    float best = POOL ? dst[n] : 0.0f;
    for (int tile = t0; tile < t1; ++tile) {
      const int p0 = tile * PT;
      float acc[PT];
#pragma unroll
      for (int i = 0; i < PT; ++i) acc[i] = 0.0f;
      for (int k = 0; k < K; ++k) {
        const float wk = __ldg(W + static_cast<size_t>(k) * N + n);
        const float4* row = reinterpret_cast<const float4*>(in_t + k * cpad + p0);
#pragma unroll
        for (int i = 0; i < PT / 4; ++i) {
          const float4 v = row[i];
          acc[4 * i + 0] = fmaf(v.x, wk, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(v.y, wk, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(v.z, wk, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(v.w, wk, acc[4 * i + 3]);
        }
      }
      if (POOL) {
#pragma unroll
        for (int i = 0; i < PT; ++i) best = fmaxf(best, fmaxf(acc[i] + bn, 0.0f));
      } else {
        float4* o = reinterpret_cast<float4*>(dst + n * cpad + p0);
#pragma unroll
        for (int i = 0; i < PT / 4; ++i) {
          o[i] = make_float4(fmaxf(acc[4 * i + 0] + bn, 0.0f), fmaxf(acc[4 * i + 1] + bn, 0.0f),
                             fmaxf(acc[4 * i + 2] + bn, 0.0f), fmaxf(acc[4 * i + 3] + bn, 0.0f));
        }
      }
    }
    if (POOL) dst[n] = best;
  }
}

template <int PT>
__global__ void __launch_bounds__(kThreads)
pointnet_kernel(const float* __restrict__ x,  // (M, P, C)
                const float* __restrict__ w1, const float* __restrict__ b1,  // (C, H1), (H1,)
                const float* __restrict__ w2, const float* __restrict__ b2,  // (H1, H2), (H2,)
                const float* __restrict__ w3, const float* __restrict__ b3,  // (H2, O), (O,)
                float* __restrict__ out,                                     // (M, O)
                int P, int C, int H1, int H2, int O, int p_chunk, int cpad) {
  extern __shared__ __align__(16) float smem[];
  float* xt = smem;                  // (C, cpad)
  float* h1t = xt + C * cpad;        // (H1, cpad)
  float* h2t = h1t + H1 * cpad;      // (H2, cpad)
  float* pool = h2t + H2 * cpad;     // (O,)

  const int m = blockIdx.x;
  const float* xm = x + static_cast<size_t>(m) * P * C;
  // relu outputs are >= 0, so 0 is the identity of the running max
  for (int i = threadIdx.x; i < O; i += blockDim.x) pool[i] = 0.0f;

  for (int start = 0; start < P; start += p_chunk) {
    const int count = min(p_chunk, P - start);
    for (int i = threadIdx.x; i < C * cpad; i += blockDim.x) {
      const int c = i / cpad;
      const int p = i - c * cpad;
      xt[i] = xm[(start + (p < count ? p : 0)) * C + c];
    }
    __syncthreads();
    dense_relu<PT, false>(xt, C, cpad, w1, b1, H1, h1t);
    __syncthreads();
    dense_relu<PT, false>(h1t, H1, cpad, w2, b2, H2, h2t);
    __syncthreads();
    dense_relu<PT, true>(h2t, H2, cpad, w3, b3, O, pool);
    __syncthreads();
  }
  float* om = out + static_cast<size_t>(m) * O;
  for (int i = threadIdx.x; i < O; i += blockDim.x) om[i] = pool[i];
}

int point_tile(int p_chunk) { return p_chunk >= 32 ? 32 : 8; }

int padded_chunk(int p_chunk) {
  const int pt = point_tile(p_chunk);
  return (p_chunk + pt - 1) / pt * pt;
}

template <int PT>
int launch(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
           const void* w3, const void* b3, void* out, int M, int P, int C, int H1, int H2, int O,
           int p_chunk, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      pointnet_kernel<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pointnet_kernel<PT><<<M, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<float*>(out), P, C, H1, H2, O, p_chunk,
      padded_chunk(p_chunk));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory the kernel asks for (bytes).
size_t pointnet_smem_bytes(int C, int H1, int H2, int O, int p_chunk) {
  return (static_cast<size_t>(C + H1 + H2) * padded_chunk(p_chunk) + O) * sizeof(float);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// Weights are (in, out) row-major; p_chunk == P is the unchunked kernel.
int pointnet_f32(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                 const void* w3, const void* b3, void* out, int M, int P, int C, int H1, int H2,
                 int O, int p_chunk, void* stream) {
  if (M == 0) return 0;
  const size_t smem = pointnet_smem_bytes(C, H1, H2, O, p_chunk);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (point_tile(p_chunk) == 32)
    return launch<32>(x, w1, b1, w2, b2, w3, b3, out, M, P, C, H1, H2, O, p_chunk, smem, s);
  return launch<8>(x, w1, b1, w2, b2, w3, b3, out, M, P, C, H1, H2, O, p_chunk, smem, s);
}

}  // extern "C"
