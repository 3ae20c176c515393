// Adadelta over flat f32 buffers: one elementwise pass, one launch.
//
// Replaces both TPU kernels of pytorch_mnist_ddp_tpu/ops/pallas_adadelta.py:
//
//   apply_lr = 1  _make_kernel (fused_adadelta_flat): reads p, g, sq, ac and
//                 lr; writes p, sq, ac in place.
//   apply_lr = 0  _make_delta_kernel (adadelta_update_flat): reads g, sq, ac;
//                 writes delta over g's buffer (the TPU kernel's
//                 input_output_aliases={0: 0}) and sq, ac in place.  The
//                 caller applies p - lr * delta.
//
// Per element, torch's optim.Adadelta recurrence in the order of
// pytorch_mnist_ddp_tpu/ops/adadelta.py:48-50:
//
//     sq    <- rho * sq + ((1 - rho) * g) * g
//     delta <- (sqrt(ac + eps) / sqrt(sq + eps)) * g
//     ac    <- rho * ac + ((1 - rho) * delta) * delta
//     p     <- p - lr * delta
//
// Every step is an __f*_rn intrinsic: nvcc would otherwise contract a*b + c
// into an FMA (one rounding where the reference rounds twice), and sqrt and
// division are IEEE-rounded whatever the build flags.  rho, 1 - rho, eps and
// lr arrive as floats the host rounds once, as torch rounds a Python scalar
// against an f32 tensor, so the kernel matches the plain PyTorch version
// (ops/adadelta.py) bit for bit.
//
// Bound on an H100 SXM (3.35 TB/s): memory.  About 15 flops per element
// against 24 bytes (apply_lr = 0: g, sq, ac read, delta, sq, ac written) or
// 28 bytes (apply_lr = 1: p read and written too, g only read).  At the
// model's N = 1,199,882 that is 28.80 MB or 8.60 us, and 33.60 MB or
// 10.03 us; the 18 Mflop take 0.27 us at the 67 TFLOP/s f32 rate.
//
// Design (simple first): a grid-stride loop with 16-byte float4 loads and
// stores when every pointer is 16-byte aligned (torch's allocations are),
// each element's loads and stores independent of every other, and a scalar
// tail.  The grid is capped at 132 SMs x 8 blocks of 256 threads, so one
// launch fills the card at N ~ 1.2M (300k float4s, about 1.1 per thread)
// and small N launches only the blocks it needs.  Nothing carries across
// blocks, unlike the TPU's sequential grid.  What is left on the table:
// the state is read from HBM whenever the 50 MB L2 has lost it, and the
// caller's concat of the grads and its p - lr * delta pass move the same
// bytes again; fusing either into the backward is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;
constexpr int SMS = 132;

struct Coeffs {
  float rho, one_minus_rho, eps, lr;
};

// One element: returns delta, updates sq and ac.
__device__ __forceinline__ float step(float g, float& sq, float& ac, const Coeffs& c) {
  const float s = __fadd_rn(__fmul_rn(c.rho, sq), __fmul_rn(__fmul_rn(c.one_minus_rho, g), g));
  const float d = __fmul_rn(__fdiv_rn(__fsqrt_rn(__fadd_rn(ac, c.eps)),
                                      __fsqrt_rn(__fadd_rn(s, c.eps))), g);
  ac = __fadd_rn(__fmul_rn(c.rho, ac), __fmul_rn(__fmul_rn(c.one_minus_rho, d), d));
  sq = s;
  return d;
}

__device__ __forceinline__ void one(float* __restrict__ p, float* __restrict__ g,
                                    float* __restrict__ sq, float* __restrict__ ac,
                                    int64_t i, const Coeffs& c, bool apply_lr) {
  float s = sq[i], a = ac[i];
  const float d = step(g[i], s, a, c);
  if (apply_lr) {
    p[i] = __fsub_rn(p[i], __fmul_rn(c.lr, d));
  } else {
    g[i] = d;
  }
  sq[i] = s;
  ac[i] = a;
}

__global__ void __launch_bounds__(THREADS)
adadelta_kernel(float* __restrict__ p, float* __restrict__ g, float* __restrict__ sq,
                float* __restrict__ ac, int64_t n, Coeffs c, int apply_lr, int vec) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t tid = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  int64_t done = 0;
  if (vec) {
    const int64_t n4 = n / 4;
    float4* p4 = reinterpret_cast<float4*>(p);
    float4* g4 = reinterpret_cast<float4*>(g);
    float4* sq4 = reinterpret_cast<float4*>(sq);
    float4* ac4 = reinterpret_cast<float4*>(ac);
    for (int64_t i = tid; i < n4; i += stride) {
      const float4 gv = g4[i];
      float4 s = sq4[i], a = ac4[i];
      float4 d;
      d.x = step(gv.x, s.x, a.x, c);
      d.y = step(gv.y, s.y, a.y, c);
      d.z = step(gv.z, s.z, a.z, c);
      d.w = step(gv.w, s.w, a.w, c);
      if (apply_lr) {
        float4 pv = p4[i];
        pv.x = __fsub_rn(pv.x, __fmul_rn(c.lr, d.x));
        pv.y = __fsub_rn(pv.y, __fmul_rn(c.lr, d.y));
        pv.z = __fsub_rn(pv.z, __fmul_rn(c.lr, d.z));
        pv.w = __fsub_rn(pv.w, __fmul_rn(c.lr, d.w));
        p4[i] = pv;
      } else {
        g4[i] = d;
      }
      sq4[i] = s;
      ac4[i] = a;
    }
    done = n4 * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride) one(p, g, sq, ac, i, c, apply_lr != 0);
}

}  // namespace

// C entry point for ctypes.  p may be null when apply_lr == 0; the Python
// wrapper checks lengths, dtype and contiguity.  Returns the CUDA error code
// of the launch (0 = cudaSuccess).
extern "C" int adadelta_launch(int device, float* p, float* g, float* sq, float* ac,
                               long long n, float rho, float one_minus_rho, float eps,
                               float lr, int apply_lr, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  uintptr_t bits = reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(sq) |
                   reinterpret_cast<uintptr_t>(ac);
  if (apply_lr) bits |= reinterpret_cast<uintptr_t>(p);
  const int vec = (bits % 16) == 0;
  const long long items = vec ? (n / 4 + n % 4) : n;
  long long blocks = (items + THREADS - 1) / THREADS;
  if (blocks > (long long)SMS * BLOCKS_PER_SM) blocks = (long long)SMS * BLOCKS_PER_SM;
  const Coeffs c{rho, one_minus_rho, eps, lr};
  adadelta_kernel<<<static_cast<int>(blocks), THREADS, 0, stream>>>(p, g, sq, ac, n, c,
                                                                   apply_lr, vec);
  return static_cast<int>(cudaGetLastError());
}
