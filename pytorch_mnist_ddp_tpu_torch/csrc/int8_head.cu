// Fused int8 dense head of the MNIST CNN: one launch from the flattened conv
// features to the pre-softmax logits.
//
// Replaces the TPU kernel pytorch_mnist_ddp_tpu/ops/pallas_infer.py:_head_kernel
// (fused_int8_head).  Per row of x:
//
//     q1 <- clip(rint(x / a1), -127, 127),   a1 = max|x| / 127 (1 if 0)
//     h  <- relu(float(q1 . W1[o]) * (a1 * s1[o]) + b1[o])       o < 128
//     q2 <- clip(rint(h / a2), -127, 127),   a2 = max|h| / 127 (1 if 0)
//     y  <- float(q2 . W2[o]) * (a2 * s2[o]) + b2[o]             o < 10
//
// Arithmetic matches pytorch_mnist_ddp_tpu/models/quant.py:_int8_dense op for
// op: IEEE division (never a reciprocal multiply; build without
// --use_fast_math), round half to even (rintf), exact int32 dot products,
// int32 -> float with __int2float_rn (|acc| reaches 127*127*9216 ~ 1.5e8, past
// 2^24), and the epilogue as __fmul_rn/__fadd_rn in the reference's order so
// nvcc cannot contract it into an FMA — a 1-ulp change in h can flip a code
// of the second layer.
//
// Layouts (torch's): x f32 [n, k]; W1 int8 [h, k] (one output per row, fc1
// columns in NCHW order); s1, b1 f32 [h]; W2 int8 [o, h]; s2, b2 f32 [o];
// out f32 [n, o].
//
// Bound on an H100 SXM (3.35 TB/s, 1,979 int8 TOP/s): memory.  At n = 128 the
// head must read x (4.72 MB) and W1 (1.18 MB), ~5.9 MB or ~1.8 us; its 0.30 G
// int8 operations take ~0.15 us.  At n = 1 the bound is W1 alone, ~0.36 us.
//
// Design (simple first): one block of 1024 threads per ROWS = 2 rows.  The
// block reads its rows of x twice (max, then quantize; the second read mostly
// hits L1) and keeps the int8 codes in shared memory; W1 (1.18 MB) stays
// resident in the 50 MB L2 across blocks, so HBM sees x and W1 about once
// each, as the bound counts them.  The fc1 product runs on __dp4a: each of
// the 32 warps owns OB = 4 outputs, lanes stride over k in 16-byte chunks,
// and one chunk of W1 serves both rows.  That loop is bound by the bytes one
// SM keeps in flight from L2, which is why the block is wide and holds few
// rows.  The relu'd h stays in shared memory, is requantized per row, and the
// 128 x 10 second product and its epilogue run in the same block.  What this
// leaves on the table: every block streams all of W1 through one SM, and
// dp4a, not the tensor cores, does the product; splitting fc1's columns
// across blocks and mma/wgmma are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 2;
constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int OB = 4;
constexpr float QMAX = 127.0f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// a_max > 0 ? a_max / 127 : 1
__device__ __forceinline__ float act_scale(float a_max) {
  return a_max > 0.0f ? __fdiv_rn(a_max, QMAX) : 1.0f;
}

// clip(rint(v / scale), -127, 127) as an integer code
__device__ __forceinline__ int quant(float v, float scale) {
  float q = rintf(__fdiv_rn(v, scale));
  return __float2int_rn(fminf(fmaxf(q, -QMAX), QMAX));
}

// acc * (a_scale * s) + b, rounded step by step
__device__ __forceinline__ float epilogue(int acc, float a_scale, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(a_scale, s)), b);
}

__device__ __forceinline__ float absmax4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

__global__ void __launch_bounds__(THREADS)
int8_head_kernel(const float* __restrict__ x, int n, int k,
                 const int8_t* __restrict__ w1, const float* __restrict__ s1,
                 const float* __restrict__ b1, int h,
                 const int8_t* __restrict__ w2, const float* __restrict__ s2,
                 const float* __restrict__ b2, int o, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* xq = reinterpret_cast<int8_t*>(smem);               // [ROWS][k]
  float* hbuf = reinterpret_cast<float*>(smem + ROWS * k);   // [ROWS][h]
  int8_t* hq = reinterpret_cast<int8_t*>(hbuf + ROWS * h);   // [ROWS][h]
  __shared__ float partial[ROWS][WARPS];
  __shared__ float scale1[ROWS];
  __shared__ float scale2[ROWS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * ROWS;
  const int k4 = k / 4;

  // 1. Per-row max |x| (rows past n stay zero: scale 1, codes 0).  Rows
  // interleave inside the loop so several loads are in flight per thread.
  const int valid = min(ROWS, n - row0);
  const float4* xr[ROWS];
  float m[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    xr[r] = reinterpret_cast<const float4*>(x + (size_t)(row0 + min(r, valid - 1)) * k);
    m[r] = 0.0f;
  }
#pragma unroll 3
  for (int c = tid; c < k4; c += THREADS) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < valid) m[r] = fmaxf(m[r], absmax4(xr[r][c]));
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = warp_max(m[r]);
    if (lane == 0) partial[r][warp] = m[r];
  }
  __syncthreads();
  if (tid < ROWS) {
    float a = 0.0f;
    for (int w = 0; w < WARPS; ++w) a = fmaxf(a, partial[tid][w]);
    scale1[tid] = act_scale(a);
  }
  __syncthreads();

  // 2. Quantize the rows into shared memory (the second read of x mostly
  // hits L1).
  char4* xq_c4 = reinterpret_cast<char4*>(xq);
#pragma unroll 3
  for (int c = tid; c < k4; c += THREADS) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      char4 q4 = make_char4(0, 0, 0, 0);
      if (r < valid) {
        const float4 v = xr[r][c];
        const float sc = scale1[r];
        q4 = make_char4(quant(v.x, sc), quant(v.y, sc), quant(v.z, sc), quant(v.w, sc));
      }
      xq_c4[r * k4 + c] = q4;
    }
  }
  __syncthreads();

  // 3. fc1: int32 dot products on dp4a, epilogue + relu into hbuf.
  const int kc = k / 16;
  const int4* xq4 = reinterpret_cast<const int4*>(xq);
  for (int o0 = warp * OB; o0 < h; o0 += WARPS * OB) {
    int acc[OB][ROWS];
#pragma unroll
    for (int j = 0; j < OB; ++j)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) acc[j][r] = 0;
#pragma unroll 2
    for (int c = lane; c < kc; c += 32) {
      int4 wv[OB];
#pragma unroll
      for (int j = 0; j < OB; ++j)
        wv[j] = __ldg(reinterpret_cast<const int4*>(w1 + (size_t)(o0 + j) * k) + c);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int4 xv = xq4[r * kc + c];
#pragma unroll
        for (int j = 0; j < OB; ++j) {
          acc[j][r] = __dp4a(xv.x, wv[j].x, acc[j][r]);
          acc[j][r] = __dp4a(xv.y, wv[j].y, acc[j][r]);
          acc[j][r] = __dp4a(xv.z, wv[j].z, acc[j][r]);
          acc[j][r] = __dp4a(xv.w, wv[j].w, acc[j][r]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < OB; ++j) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int sum = warp_sum(acc[j][r]);
        if (lane == 0) {
          const int oo = o0 + j;
          hbuf[r * h + oo] = fmaxf(epilogue(sum, scale1[r], s1[oo], b1[oo]), 0.0f);
        }
      }
    }
  }
  __syncthreads();

  // 4. Requantize h per row: warp r owns row r.
  if (warp < ROWS) {
    const float* hr = hbuf + warp * h;
    float mm = 0.0f;
    for (int c = lane; c < h; c += 32) mm = fmaxf(mm, fabsf(hr[c]));
    const float sc = act_scale(warp_max(mm));
    if (lane == 0) scale2[warp] = sc;
    for (int c = lane; c < h; c += 32) hq[warp * h + c] = static_cast<int8_t>(quant(hr[c], sc));
  }
  __syncthreads();

  // 5. fc2: one warp per (row, output) pair, lanes over 4-byte words of h.
  const int hw = h / 4;
  for (int p = warp; p < ROWS * o; p += WARPS) {
    const int r = p / o;
    const int oo = p % o;
    if (row0 + r >= n) continue;
    const int* a = reinterpret_cast<const int*>(hq + r * h);
    const int* b = reinterpret_cast<const int*>(w2 + (size_t)oo * h);
    int acc = 0;
    for (int c = lane; c < hw; c += 32) acc = __dp4a(a[c], b[c], acc);
    acc = warp_sum(acc);
    if (lane == 0) out[(size_t)(row0 + r) * o + oo] = epilogue(acc, scale2[r], s2[oo], b2[oo]);
  }
}

}  // namespace

// C entry point for ctypes.  Shapes are checked by the Python wrapper
// (k % 16 == 0, h % 16 == 0, 16-byte aligned pointers).  Returns the CUDA
// error code of the launch (0 = cudaSuccess).
extern "C" int int8_head_launch(int device, const float* x, int n, int k,
                                const int8_t* w1, const float* s1, const float* b1, int h,
                                const int8_t* w2, const float* s2, const float* b2, int o,
                                float* out, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = (size_t)ROWS * k + (size_t)ROWS * h * sizeof(float) + (size_t)ROWS * h;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(int8_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n + ROWS - 1) / ROWS;
  int8_head_kernel<<<blocks, THREADS, smem, stream>>>(x, n, k, w1, s1, b1, h, w2, s2, b2, o, out);
  return static_cast<int>(cudaGetLastError());
}
