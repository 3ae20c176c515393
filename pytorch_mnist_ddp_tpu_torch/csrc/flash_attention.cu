// Flash attention, f32: the online-softmax fold of q against streamed k/v
// tiles, one launch for a whole attention call or one ring hop.
//
// Replaces both TPU kernels of pytorch_mnist_ddp_tpu/ops/pallas_attention.py,
// which share one body (_fold_block):
//
//   mode 0 (fwd)      _fwd_kernel (via _flash_fwd): the state starts empty
//                     (m = -1e30, l = 0, acc = 0); after the last key tile
//                     it writes out = acc / l (0 where l == 0) and
//                     lse = m + log(l).
//   mode 1 (partial)  _partial_kernel (via _flash_partial): one ring hop.
//                     The state (m, l, acc) is read, the visiting k/v block
//                     folded in, and the raw state written back.  The output
//                     pointers may equal the input ones (the TPU kernel's
//                     input_output_aliases): every thread reads its rows'
//                     state before the first __syncthreads and writes it
//                     after the last, so no pointer is __restrict__.
//
// Per key tile, for each query row (the arithmetic of ops/attention.py
// block_update, masked key columns excluded):
//
//     s     = (q . k_j) * scale               (scale = 1/sqrt(d), f32)
//     m_new = max(m, max_j s_j)
//     p_j   = exp(s_j - m_new)                (0 for keys past t_kv)
//     l     = l * exp(m - m_new) + sum_j p_j
//     acc   = acc * exp(m - m_new) + sum_j p_j v_j
//
// Layouts (JAX's, nothing padded): q, k, v [b, t, h, d] given by their
// (b, t, h) element strides with stride 1 along d, so the q/k/v views of the
// ViT's head-major qkv projection go in without a copy; out [b, tq, h, d]
// contiguous; lse [b, h, tq]; state m, l [b, h, tq] and acc [b, h, tq, d]
// contiguous (ops/attention.py BlockAcc).  The ragged last key tile is
// masked by index, not by padding.
//
// What bounds it on an H100 SXM: at the ViT's shapes (t = 16, d = 16) the
// whole call moves 1-16 MB and does 4*b*h*t^2*d = 0.07-1 Gflop, so launch
// latency and bytes bound it (bound 0.3-5 us).  At long t the f32
// operations do: 4*b*h*t^2*d = 34 Gflop at (1, 8192, 2, 64), 0.51 ms at the
// 67 TFLOP/s f32 rate, against 8.4 MB of traffic (2.5 us).
//
// Design (simple first): one block of 128 threads per (b*h, query tile of
// BQ rows); BQ = 16 when tq <= 16, else 64, so each row has 8 or 2 threads.
// The q tile stays in shared memory; k and v tiles of 32 rows stream
// through shared memory in a loop over key tiles, which takes the place of
// the TPU's sequential "arbitrary" grid axis.  Each thread keeps its row's
// (m, l) and its d/TPR output columns in registers; row max and row sum go
// through warp shuffles.  Products are f32 on the CUDA cores (no TF32, no
// tensor cores), exp/log are the IEEE-accurate expf/logf (no fast math),
// and d <= 128 (the Python wrapper refuses more).  Shared-memory rows of q
// and k have an odd pitch (d + 1), so the rows one warp reads sit in
// distinct banks.  What is left on the table: the score loop does one
// shared-memory load per FMA, and at long t only 2-8 blocks land on each
// SM; mma/wgmma tiles, TMA and bf16 are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int BK = 32;  // key rows per tile
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;

enum Mode { FWD = 0, PARTIAL = 1 };

struct Params {
  const float* q;
  const float* k;
  const float* v;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh;
  int heads, tq, tkv, d, mode;
  float scale;
  float* out;   // fwd: [b, tq, h, d]
  float* lse;   // fwd: [b, h, tq]
  const float* m_in;  // partial: [b, h, tq]
  const float* l_in;
  const float* a_in;  // partial: [b, h, tq, d]
  float* m_out;
  float* l_out;
  float* a_out;
};

template <int BQ, int DMAX>
__global__ void __launch_bounds__(THREADS) flash_kernel(Params p) {
  constexpr int TPR = THREADS / BQ;  // threads per query row
  constexpr int NS = BK / TPR;       // scores per thread and key tile
  constexpr int NACC = DMAX / TPR;   // output columns per thread
  extern __shared__ float smem[];
  const int d = p.d;
  const int ldq = d + 1;
  const int ldp = BK + 1;
  float* Qs = smem;            // [BQ][d + 1]
  float* Ks = Qs + BQ * ldq;   // [BK][d + 1]
  float* Vs = Ks + BK * ldq;   // [BK][d]
  float* Ps = Vs + BK * d;     // [BQ][BK + 1]

  const int nq = (p.tq + BQ - 1) / BQ;
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x - bh * nq) * BQ;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int tid = threadIdx.x;
  const int r = tid / TPR, c = tid - r * TPR;
  const int row = q0 + r;
  const bool live = row < p.tq;

  const float* qb = p.q + b * p.sqb + h * p.sqh;
  const float* kb = p.k + b * p.skb + h * p.skh;
  const float* vb = p.v + b * p.svb + h * p.svh;
  for (int i = tid; i < BQ * d; i += THREADS) {
    const int rr = i / d, cc = i - rr * d;
    Qs[rr * ldq + cc] = q0 + rr < p.tq ? qb[(long long)(q0 + rr) * p.sqt + cc] : 0.f;
  }

  const long long srow = (long long)bh * p.tq + row;  // row of the state / lse
  float m = NEG_INF, l = 0.f, acc[NACC];
  if (p.mode == PARTIAL && live) {
    m = p.m_in[srow];
    l = p.l_in[srow];
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int col = c + i * TPR;
      acc[i] = col < d ? p.a_in[srow * d + col] : 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  }

  const float* qr = Qs + r * ldq;
  float* pr = Ps + r * ldp;
  const int nk = (p.tkv + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * d; i += THREADS) {
      const int j = i / d, cc = i - j * d;
      const bool in = k0 + j < p.tkv;
      Ks[j * ldq + cc] = in ? kb[(long long)(k0 + j) * p.skt + cc] : 0.f;
      Vs[j * d + cc] = in ? vb[(long long)(k0 + j) * p.svt + cc] : 0.f;
    }
    __syncthreads();

    float s[NS];
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) s[jj] = 0.f;
    for (int e = 0; e < d; ++e) {
      const float qv = qr[e];
#pragma unroll
      for (int jj = 0; jj < NS; ++jj) s[jj] = fmaf(qv, Ks[(c + jj * TPR) * ldq + e], s[jj]);
    }
    float mx = NEG_INF;
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
      s[jj] = k0 + c + jj * TPR < p.tkv ? s[jj] * p.scale : NEG_INF;
      mx = fmaxf(mx, s[jj]);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, off));
    const float m_new = fmaxf(m, mx);
    float ps = 0.f;
#pragma unroll
    for (int jj = 0; jj < NS; ++jj) {
      const float pj = k0 + c + jj * TPR < p.tkv ? expf(s[jj] - m_new) : 0.f;
      pr[c + jj * TPR] = pj;
      ps += pj;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1) ps += __shfl_xor_sync(FULL_MASK, ps, off);
    const float corr = expf(m - m_new);  // 1 while both are still -1e30
    l = l * corr + ps;
    m = m_new;
    __syncwarp();  // a row's p values, written by its lanes, are visible to all of them
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] *= corr;
    const int kn = min(BK, p.tkv - k0);
    for (int j = 0; j < kn; ++j) {
      const float pj = pr[j];
      const float* vr = Vs + j * d;
#pragma unroll
      for (int i = 0; i < NACC; ++i) {
        const int col = c + i * TPR;
        if (col < d) acc[i] = fmaf(pj, vr[col], acc[i]);
      }
    }
  }

  if (!live) return;
  if (p.mode == FWD) {
    float* o = p.out + (((long long)b * p.tq + row) * p.heads + h) * d;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int col = c + i * TPR;
      if (col < d) o[col] = l > 0.f ? acc[i] / l : 0.f;
    }
    if (c == 0) p.lse[srow] = m + logf(l > 0.f ? l : 1.f);
  } else {
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int col = c + i * TPR;
      if (col < d) p.a_out[srow * d + col] = acc[i];
    }
    if (c == 0) {
      p.m_out[srow] = m;
      p.l_out[srow] = l;
    }
  }
}

template <int BQ, int DMAX>
int launch(const Params& p, long long bh, cudaStream_t stream) {
  const size_t floats = (size_t)BQ * (p.d + 1) + (size_t)BK * (p.d + 1) + (size_t)BK * p.d +
                        (size_t)BQ * (BK + 1);
  const size_t smem = floats * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<BQ, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = bh * ((p.tq + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_kernel<BQ, DMAX><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int BQ>
int launch_d(const Params& p, long long bh, cudaStream_t stream) {
  if (p.d <= 32) return launch<BQ, 32>(p, bh, stream);
  if (p.d <= 64) return launch<BQ, 64>(p, bh, stream);
  return launch<BQ, 128>(p, bh, stream);
}

}  // namespace

// C entry point for ctypes.  mode 0 writes out and lse (the state pointers
// may be null); mode 1 reads m_in, l_in, a_in and writes m_out, l_out,
// a_out, which may be the same buffers (out and lse may be null).  The
// Python wrapper checks devices, dtypes, shapes, strides and 1 <= d <= 128.
// Returns the CUDA error code of the launch (0 = cudaSuccess).
extern "C" int flash_attention_launch(
    int device, int mode, const float* q, const float* k, const float* v,
    long long sqb, long long sqt, long long sqh, long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh, int batch, int heads, int tq, int tkv, int d,
    float scale, float* out, float* lse, const float* m_in, const float* l_in,
    const float* a_in, float* m_out, float* l_out, float* a_out, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d < 1 || d > 128 || tq < 1 || tkv < 1 || (mode != FWD && mode != PARTIAL)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long bh = (long long)batch * heads;
  if (bh == 0) return 0;
  const Params p{q, k, v, sqb, sqt, sqh, skb, skt, skh, svb, svt, svh,
                 heads, tq, tkv, d, mode, scale, out, lse,
                 m_in, l_in, a_in, m_out, l_out, a_out};
  return tq <= 16 ? launch_d<16>(p, bh, stream) : launch_d<64>(p, bh, stream);
}
