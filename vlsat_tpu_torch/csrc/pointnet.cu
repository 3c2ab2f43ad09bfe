// Fused three-layer PointNet encoder for NVIDIA Hopper (sm_90a), on the
// tensor cores in 3xTF32.
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
// per instance against ~1.5 KB of points in and 3 KB out.  The products
// must stay fp32-accurate (the twin gate is rtol 1e-4 / atol 1e-5), and the
// card's fastest fp32-accurate route is the tensor cores in 3xTF32
// (tf32x3.cuh): three TF32 products per fp32 product.  So the least time is
// 3 * FLOPs / 495 TFLOP/s (TF32, dense), not FLOPs / 67 TFLOP/s (fp32 on
// the CUDA cores): 0.254 ms for the 1,536 instances of node bucket 48.
//
// Design.  A block of 8 warps (two warpgroups) owns a tile of 128 point
// rows: one instance at P=128, or several instances when an instance has
// fewer rows (the block then owns G of them), or one instance walked tile
// by tile when it has more.  Each instance's points are taken in slabs of
// p_chunk points (p_chunk = P for the unchunked kernel), each slab padded
// to a multiple of 16 rows with copies of its first point, which leaves
// the max unchanged.
//
// - Layers 1 and 2 (8 % of the FLOPs; layer 1 with K = C zero-padded to
//   8) are mma.sync m16n8k8 products, each one 128 x 128 tile over the 8
//   warps (32 rows x 64 columns a warp), operands split into hi/lo in
//   registers after ldmatrix loads.  Matrices they read are K-contiguous
//   with rows padded by 4 floats, free of bank conflicts.  No ldmatrix or
//   mma sits under a branch: the compiler guards each such warp-wide
//   instruction with a WARPSYNC, which measured twice as slow, so partial
//   tiles compute on clamped rows and only their stores are masked.
// - Layer 3 (92 %) is wgmma m64n64k8 (TF32): the only route to the
//   tensor cores' full rate (mma.sync peaks near two thirds of it in TF32
//   on the card, tools/torch_mma_probe.py).  It computes out^T: M = 64
//   channels of W3, N = 64 points a warpgroup, K = H2.  The B operand,
//   h2 = relu(h1 W2^T + b2), is split
//   once, in the layer-2 epilogue, into hi and lo planes in shared memory
//   in the K-major 128-byte-swizzled layout wgmma reads by descriptor.  The
//   A operand, W3, comes from registers: each k-step loads its fragment
//   with one ldmatrix, splits it, and issues the three products, while the
//   previous k-step's products run (fragments double-buffered).
// - W3 streams through a two-slot ring of (64, H2) tiles filled by
//   cp.async, two tiles ahead: the first two land while layers 1-2 run,
//   each later one while the tile before it is multiplied.  h1, W2 and W1
//   live where the h2 planes will be; layer 2 keeps its output in
//   registers until h1 is dead.
// - Points run along the accumulator's columns, so the max over an
//   instance's points folds in registers, then over the 4 lanes of a row
//   by two shuffles, then across warpgroups by an integer atomicMax into a
//   shared (G, O) pool (every value is >= 0, where float order and int
//   order agree).  Only (M, O) reaches device memory.
//
// One block fills an SM (~206 KB of shared memory); TMA tensor maps and
// overlapping the epilogue with the next tile's products are left for
// later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 256;  // 2 warpgroups; as 8 warps, 4 along the rows x 2 along the columns
constexpr int kRows = 128;     // point rows of one tile
constexpr int kHidden = 128;   // widest H1 and H2: layers 1-2 run as one product tile
constexpr int kCols = 64;      // W3 rows (channels) of one layer-3 tile, the wgmma M
constexpr int kPad = 4;        // row padding of the padded shared matrices, in floats
constexpr int kPool = 4096;    // floats of the per-block pool of instance maxima
constexpr int kSwizzle = 128;  // bytes of a row of one K-block of the h2 planes
constexpr int kAlign = 1024;   // the 128-byte swizzle repeats every 8 rows of 128 bytes

__host__ __device__ inline int round8(int k) { return (k + 7) / 8 * 8; }

__host__ __device__ inline int slab_rows(int p_chunk) { return (p_chunk + 15) / 16 * 16; }

__host__ __device__ inline int inst_rows(int P, int p_chunk) {
  return P / p_chunk * slab_rows(p_chunk);
}

// Instances of one block: as many whole ones as 128 rows hold, as far as
// their (G, O) pool fits in kPool floats.
__host__ __device__ inline int insts_per_block(int P, int p_chunk, int O) {
  const int r = inst_rows(P, p_chunk);
  const int g = r <= kRows ? kRows / r : 1;
  const int fit = kPool / O > 1 ? kPool / O : 1;
  return g < fit ? g : fit;
}

// Bytes of one h2 plane: K-blocks of 32 values (128 bytes) by kRows rows.
__host__ __device__ inline int plane_bytes(int H2) { return (H2 + 31) / 32 * kRows * kSwizzle; }

// Bytes of the region that holds h1, W2 and W1 during layers 1-2 and the
// h2 hi/lo planes after.
__host__ __device__ inline int front_bytes(int C, int H1, int H2) {
  const int planes = 2 * plane_bytes(H2);
  const int stage = ((kRows + H2) * (H1 + kPad) + H1 * (round8(C) + kPad)) * 4;
  return planes > stage ? planes : stage;
}

// Word offset of h2[n][k] in a plane: K-block k / 32, row n, and the
// 16-byte chunk of the row XORed with n % 8 (the 128-byte swizzle).
__device__ __forceinline__ int plane_word(int n, int k) {
  return (k >> 5) * (kRows * kSwizzle / 4) + n * (kSwizzle / 4) +
         ((((k & 31) >> 2) ^ (n & 7)) << 2) + (k & 3);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying rows [0, n) of the (n, k) row-major src into dst, row
// stride k + kPad; k is a multiple of 4.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int n, int k) {
  const int cpr = k / 4;  // 16-byte chunks per row
  int r = threadIdx.x / cpr, c = threadIdx.x - r * cpr;
  const int dr = kThreads / cpr, dc = kThreads - dr * cpr;
  for (; r < n; r += dr, c += dc) {
    if (c >= cpr) {
      c -= cpr;
      ++r;
      if (r >= n) break;
    }
    cp_async16(dst + r * (k + kPad) + 4 * c, src + static_cast<size_t>(r) * k + 4 * c);
  }
}

// acc[i][j] += A[16i:16i+16, :K] B[n0+8j:n0+8j+8, :K]^T over the warp's
// 2 x 8 mma.sync tiles.  A and B are fp32, K-contiguous in shared memory,
// rows 16-byte aligned, K a multiple of 8; A has its 32 rows, and rows of B
// at or past nb read row nb - 1.  Both are split here; the three products
// go as three passes over all the tiles, so no MMA waits on the one before.
__device__ __forceinline__ void warp_mma(const float* A, int lda, const float* B, int ldb, int n0,
                                         int nb, int K, float (&acc)[2][8][4]) {
  const int lane = threadIdx.x & 31;
  const int q = lane >> 3, r = lane & 7;  // the ldmatrix matrix and row this lane addresses
  const int a_off = (r + 8 * (q & 1)) * lda + 4 * (q >> 1);
  const float* b[4];  // n-tiles 2jj and 2jj+1 per ldmatrix
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    b[jj] = B + min(n0 + 16 * jj + 8 * (q >> 1) + r, nb - 1) * ldb + 4 * (q & 1);
  }
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    uint32_t ah[2][4], al[2][4], bh[8][2], bl[8][2];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t f[4];
      tf32x3::ldmatrix_x4(f, b[jj] + k0);
      tf32x3::split(f[0], bh[2 * jj][0], bl[2 * jj][0]);
      tf32x3::split(f[1], bh[2 * jj][1], bl[2 * jj][1]);
      tf32x3::split(f[2], bh[2 * jj + 1][0], bl[2 * jj + 1][0]);
      tf32x3::split(f[3], bh[2 * jj + 1][1], bl[2 * jj + 1][1]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      uint32_t f[4];
      tf32x3::ldmatrix_x4(f, A + a_off + i * 16 * lda + k0);
#pragma unroll
      for (int v = 0; v < 4; ++v) tf32x3::split(f[v], ah[i][v], al[i][v]);
    }
    // the small products first: lo*hi, hi*lo, then hi*hi
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          tf32x3::mma(acc[i][j], pass == 0 ? al[i] : ah[i], pass == 1 ? bl[j] : bh[j]);
        }
      }
    }
  }
}

// relu(acc + bias) over the warp's kept tiles (rows row0 + 16i + g and + 8,
// columns col0 + 8j + 2t, +1): PLANES, split into the h2 planes hi and lo;
// else in fp32 into dst, row stride ld.
template <bool PLANES>
__device__ __forceinline__ void store_relu(const float (&acc)[2][8][4], const float* __restrict__ bias,
                                           float* dst, float* lo, int ld, int row0, int col0,
                                           int mt, int nt) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (i < mt && j < nt) {
        const int col = col0 + j * 8 + 2 * t;
        const float c0 = __ldg(bias + col), c1 = __ldg(bias + col + 1);
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // rows g and g + 8
          const int row = row0 + i * 16 + g + 8 * h;
          const float v0 = fmaxf(acc[i][j][2 * h] + c0, 0.0f);
          const float v1 = fmaxf(acc[i][j][2 * h + 1] + c1, 0.0f);
          if constexpr (PLANES) {
            uint32_t h0, l0, h1, l1;
            tf32x3::split(__float_as_uint(v0), h0, l0);
            tf32x3::split(__float_as_uint(v1), h1, l1);
            const int at = plane_word(row, col);  // col is even: col, col + 1 share a chunk
            *reinterpret_cast<uint2*>(dst + at) = make_uint2(h0, h1);
            *reinterpret_cast<uint2*>(lo + at) = make_uint2(l0, l1);
          } else {
            *reinterpret_cast<float2*>(dst + row * ld + col) = make_float2(v0, v1);
          }
        }
      }
    }
  }
}

// A wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the leading offset is unused in this layout).
__device__ __forceinline__ uint64_t swizzled_desc(uint32_t smem_addr) {
  return static_cast<uint64_t>((smem_addr & 0x3ffff) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(kAlign >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += a * b: A (64 x 8, TF32) from registers in the mma.sync A-fragment
// layout (each warp its 16 rows), B (8 x 64) from shared memory.
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// One layer-3 k-step of a warpgroup: load and split the W3 fragment (the
// warp's 16 channels x 8 K values at `a`), then the three products against
// the h2 planes' descriptors.  Leaves this k-step's group in flight and the
// one before it finished, so the other fragment buffer is free again.
__device__ __forceinline__ void l3_step(float (&d)[32], const float* a, uint64_t hi, uint64_t lo,
                                        uint32_t (&ah)[4], uint32_t (&al)[4]) {
  uint32_t f[4];
  tf32x3::ldmatrix_x4(f, a);
#pragma unroll
  for (int v = 0; v < 4; ++v) tf32x3::split(f[v], ah[v], al[v]);
  wgmma_fence();
  wgmma_m64n64k8(d, al, hi);
  wgmma_m64n64k8(d, ah, lo);
  wgmma_m64n64k8(d, ah, hi);
  wgmma_commit();
  wgmma_wait<1>();
}

// Max over the 4 lanes of an accumulator row (lanes with the same g).
__device__ __forceinline__ float row_lanes_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__global__ void __launch_bounds__(kThreads, 1)
pointnet_kernel(const float* __restrict__ x,                                 // (M, P, C)
                const float* __restrict__ w1, const float* __restrict__ b1,  // (H1, C), (H1,)
                const float* __restrict__ w2, const float* __restrict__ b2,  // (H2, H1), (H2,)
                const float* __restrict__ w3, const float* __restrict__ b3,  // (O, H2), (O,)
                float* __restrict__ out,                                     // (M, O)
                int M, int P, int C, int H1, int H2, int O, int p_chunk) {
  const int sp = slab_rows(p_chunk);
  const int R = inst_rows(P, p_chunk);
  const int G = insts_per_block(P, p_chunk, O);
  const int m0 = blockIdx.x * G;
  const int live = min(G, M - m0);
  const int rows_total = live * R;
  const int kc = round8(C);
  const int ldx = kc + kPad, ld1 = H1 + kPad, ld2 = H2 + kPad;
  const int tiles = (O + kCols - 1) / kCols;                 // layer-3 tiles per row tile
  const int seq = (rows_total + kRows - 1) / kRows * tiles;  // W3 tiles this block multiplies

  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  unsigned char* base = smem_raw + ((kAlign - raw_addr % kAlign) % kAlign);
  float* h2_hi = reinterpret_cast<float*>(base);  // planes, each plane_bytes(H2)
  float* h2_lo = h2_hi + plane_bytes(H2) / 4;
  float* h1 = h2_hi;                              // (kRows, ld1), before h2 exists
  float* w2s = h1 + kRows * ld1;                  // (H2, ld1)
  float* w1s = w2s + H2 * ld1;                    // (H1, ldx), K zero-padded
  float* ring = reinterpret_cast<float*>(base + front_bytes(C, H1, H2));  // 2 x (kCols, ld2)
  float* xs = ring + 2 * kCols * ld2;             // (kRows, ldx), K zero-padded
  int* pool = reinterpret_cast<int*>(xs + kRows * ldx);  // (G, O) running max, as int bits

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;  // layers 1-2: the warp's 32 rows, its column half
  const int wg = warp >> 2, wq = warp & 3;  // layer 3: warpgroup (64 points), warp (16 channels)
  const int g = lane >> 2, t = lane & 3;
  const int q = lane >> 3, r8 = lane & 7;

  auto stage_w3 = [&](int s) {  // the s-th W3 tile of this block into slot s % 2
    if (s < seq) {
      const int n0 = s % tiles * kCols;
      stage_rows(ring + (s & 1) * kCols * ld2, w3 + static_cast<size_t>(n0) * H2,
                 min(kCols, O - n0), H2);
    }
    cp_async_commit();  // an empty group past the end keeps the count of groups fixed
  };

  // the warpgroup's 64 points in the hi and lo planes, as wgmma descriptors
  const uint32_t planes_addr = static_cast<uint32_t>(__cvta_generic_to_shared(h2_hi));
  const uint64_t desc_hi = swizzled_desc(planes_addr + wg * 64 * kSwizzle);
  const uint64_t desc_lo = swizzled_desc(planes_addr + plane_bytes(H2) + wg * 64 * kSwizzle);
  const int nk = H2 / 8;

  for (int i = threadIdx.x; i < G * O; i += kThreads) pool[i] = 0;

  int s = 0;  // the next W3 tile to multiply
  for (int r0 = 0; r0 < rows_total; r0 += kRows) {
    const int rows = min(kRows, rows_total - r0);  // a multiple of 16
    const int mt = max(0, min(2, (rows - wm * 32) / 16));

    stage_rows(w2s, w2, H2, H1);
    cp_async_commit();
    if (r0 == 0) {
      stage_w3(0);
      stage_w3(1);
    }
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      const int inst = (r0 + r) / R;
      const int rr = r0 + r - inst * R;
      const int slab = rr / sp, j = rr - slab * sp;
      const float* src = x + (static_cast<size_t>(m0 + inst) * P + slab * p_chunk +
                              (j < p_chunk ? j : 0)) * C;
      for (int c = 0; c < kc; ++c) xs[r * ldx + c] = c < C ? __ldg(src + c) : 0.0f;
    }
    for (int n = threadIdx.x; n < H1; n += kThreads) {
      for (int c = 0; c < kc; ++c) w1s[n * ldx + c] = c < C ? __ldg(w1 + n * C + c) : 0.0f;
    }
    if (r0 == 0) {
      cp_async_wait<2>();  // W2 has landed; the first two W3 tiles may still be coming
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // layers 1 and 2, each as one 128 x 128 product tile
    {
      float acc[2][8][4] = {};
      warp_mma(xs + wm * 32 * ldx, ldx, w1s, ldx, wn * 64, H1, kc, acc);
      const int nt = max(0, min(8, (H1 - wn * 64) / 8));
      store_relu<false>(acc, b1, h1, nullptr, ld1, wm * 32, wn * 64, mt, nt);
    }
    __syncthreads();
    {
      float acc[2][8][4] = {};
      warp_mma(h1 + wm * 32 * ld1, ld1, w2s, ld1, wn * 64, H2, H1, acc);
      const int nt = max(0, min(8, (H2 - wn * 64) / 8));
      __syncthreads();  // h1, W2 and W1 are dead: the h2 planes take their place
      store_relu<true>(acc, b2, h2_hi, h2_lo, 0, wm * 32, wn * 64, mt, nt);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // wgmma reads them
    }

    // layer 3: out^T = W3 h2^T tile by tile; the warpgroup's 64 points are
    // 4 runs of 16, each in one instance
    int inst[4];
    bool keep[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      inst[p] = (r0 + wg * 64 + 16 * p) / R;
      keep[p] = wg * 64 + 16 * p < rows;
    }
    const bool one_inst = inst[0] == inst[3] || !keep[1] ||
                          (inst[0] == inst[2] && !keep[3]) || (inst[0] == inst[1] && !keep[2]);
    for (int tile = 0; tile < tiles; ++tile, ++s) {
      const int n0 = tile * kCols;
      const int nvalid = min(kCols, O - n0);
      const int c_lo = n0 + wq * 16 + g, c_hi = c_lo + 8;  // this thread's two channels
      const float bias_lo = c_lo < O ? __ldg(b3 + c_lo) : 0.0f;
      const float bias_hi = c_hi < O ? __ldg(b3 + c_hi) : 0.0f;
      cp_async_wait<1>();  // tile s has landed; tile s + 1 may still be coming
      __syncthreads();     // for s = 0 this also publishes the h2 planes

      const float* a = ring + (s & 1) * kCols * ld2 +
                       min(wq * 16 + r8 + 8 * (q & 1), nvalid - 1) * ld2 + 4 * (q >> 1);
      float d[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) d[i] = 0.0f;
      fence_acc(d);
      uint32_t ah[2][4], al[2][4];
      int kk = 0;
      for (; kk + 1 < nk; kk += 2) {
        // K-block kk / 4 of each plane, and 32 bytes into its rows per k-step
        const uint64_t off = (kk >> 2) * (kRows * kSwizzle >> 4) + (kk & 3) * 2;
        l3_step(d, a + 8 * kk, desc_hi + off, desc_lo + off, ah[0], al[0]);
        l3_step(d, a + 8 * kk + 8, desc_hi + off + 2, desc_lo + off + 2, ah[1], al[1]);
      }
      if (kk < nk) {
        const uint64_t off = (kk >> 2) * (kRows * kSwizzle >> 4) + (kk & 3) * 2;
        l3_step(d, a + 8 * kk, desc_hi + off, desc_lo + off, ah[0], al[0]);
      }
      wgmma_wait<0>();
      fence_acc(d);

      // d[4i + 0, 1]: channel c_lo at points 8i + 2t, +1; d[4i + 2, 3]: channel c_hi
      float run_lo = -INFINITY, run_hi = -INFINITY;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float v_lo = fmaxf(fmaxf(d[8 * p], d[8 * p + 1]), fmaxf(d[8 * p + 4], d[8 * p + 5]));
        float v_hi = fmaxf(fmaxf(d[8 * p + 2], d[8 * p + 3]), fmaxf(d[8 * p + 6], d[8 * p + 7]));
        if (one_inst) {
          run_lo = keep[p] ? fmaxf(run_lo, v_lo) : run_lo;
          run_hi = keep[p] ? fmaxf(run_hi, v_hi) : run_hi;
        } else {  // instances shorter than the warpgroup's 64 points
          v_lo = row_lanes_max(v_lo);
          v_hi = row_lanes_max(v_hi);
          if (t == 0 && keep[p]) {
            // max(relu(a + c)) = max(0, max(a) + c), exactly; >= 0: int order is float order
            if (c_lo < O) atomicMax(pool + inst[p] * O + c_lo, __float_as_int(fmaxf(v_lo + bias_lo, 0.0f)));
            if (c_hi < O) atomicMax(pool + inst[p] * O + c_hi, __float_as_int(fmaxf(v_hi + bias_hi, 0.0f)));
          }
        }
      }
      if (one_inst) {
        run_lo = row_lanes_max(run_lo);
        run_hi = row_lanes_max(run_hi);
        if (t == 0 && keep[0]) {
          if (c_lo < O) atomicMax(pool + inst[0] * O + c_lo, __float_as_int(fmaxf(run_lo + bias_lo, 0.0f)));
          if (c_hi < O) atomicMax(pool + inst[0] * O + c_hi, __float_as_int(fmaxf(run_hi + bias_hi, 0.0f)));
        }
      }
      __syncthreads();  // slot s % 2 is free, and every product has read the planes
      stage_w3(s + 2);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* om = out + static_cast<size_t>(m0) * O;
  for (int i = threadIdx.x; i < live * O; i += kThreads) om[i] = __int_as_float(pool[i]);
}

}  // namespace

extern "C" {

// Shared memory the kernel asks for (bytes), or 0 for widths it does not
// take (H1 or H2 above kHidden).
size_t pointnet_smem_bytes(int P, int C, int H1, int H2, int O, int p_chunk) {
  if (H1 > kHidden || H2 > kHidden) return 0;
  const size_t floats = 2 * kCols * (H2 + kPad) + static_cast<size_t>(kRows) * (round8(C) + kPad) +
                        static_cast<size_t>(insts_per_block(P, p_chunk, O)) * O;
  return kAlign + front_bytes(C, H1, H2) + floats * sizeof(float);
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
// Weights are (out, in) row-major (nn.Linear's layout); H1, H2 and O are
// multiples of 8, H1 and H2 at most 128, P a multiple of p_chunk; p_chunk == P
// is the unchunked kernel.
int pointnet_f32(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                 const void* w3, const void* b3, void* out, int M, int P, int C, int H1, int H2,
                 int O, int p_chunk, void* stream) {
  if (M == 0) return 0;
  const size_t smem = pointnet_smem_bytes(P, C, H1, H2, O, p_chunk);
  if (smem == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(pointnet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int G = insts_per_block(P, p_chunk, O);
  pointnet_kernel<<<(M + G - 1) / G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<const float*>(w3),
      static_cast<const float*>(b3), static_cast<float*>(out), M, P, C, H1, H2, O, p_chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
