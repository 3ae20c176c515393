// Flash attention, f32-accurate on the tensor cores: the online-softmax fold
// of q against streamed k/v tiles, one launch for a whole attention call or
// one ring hop.
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
//                     input_output_aliases): each warp owns its rows, reads
//                     their state before its first product and writes it
//                     after its last, so no pointer is __restrict__.
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
// contiguous (ops/attention.py BlockAcc).  Ragged key and query tiles are
// masked by index, not by padding; 1 <= d <= 128.
//
// What bounds it on an H100 SXM.  At long t the two products:
// 4*b*h*t^2*d operations, 34 Gflop at (1, 8192, 2, 64).  On the CUDA cores
// (67 TFLOP/s f32) that is 0.51 ms.  The tensor cores take f32 operands only
// as TF32 (10-bit mantissa), and one TF32 pass misses the f32 gate (rtol
// 1e-5) by 100-700x, so each product runs as 3xTF32: x = hi + lo with
// hi = tf32(x), lo = tf32(x - hi), and a.b = hi.hi + (lo.hi + hi.lo)
// (CUTLASS's OpMultiplyAddFastF32 splits the same way).  The tensor cores
// do not round each accumulation to nearest: with all three passes in one
// accumulator the row max m drifted further from an f64 reference than the
// plain f32 version's, and l, held to rtol 1e-5, inherits m's error.
// So the small terms accumulate apart from hi.hi and join it once per tile
// (chip_smoke.py's kernel phase holds kernel and plain version against f64).
// Three passes at 495 TFLOP/s bound the call at 0.21 ms.  At the ViT's
// shapes (t = 16, d = 16) the call moves 1-16 MB and does 0.07-1 Gflop:
// launch latency and bytes bound it (0.3-5 us).
//
// Design.
// - Products: mma.sync m16n8k8 TF32 with f32 accumulators (not wgmma: its
//   TF32 B operand must be K-major, which V is not, and its 64-row tiles
//   would leave three quarters idle at t = 16).  A warp owns 16 query rows:
//   their q stays in registers as A fragments, split at use; k and v are
//   split at the fragment load.  Within each 8-wide k-step the reduction
//   index is permuted (fragment column c <-> element 2c, c + 4 <-> 2c + 1;
//   a sum does not care), so a k fragment is one 8-byte shared load and P
//   goes from the score accumulators (C layout) to the A operand of P.V in
//   registers, with no shuffle or shared-memory round trip.
// - Softmax in the C layout: each thread holds two rows (g, g + 8); row max
//   reduces over the four lanes of a quad with shuffles, the row sum l is
//   kept per thread and reduced once at the end.  Each key tile's P.V goes
//   into fresh accumulators, then acc = acc * corr + tile, so the tensor
//   cores' own accumulation never runs longer than one tile.
// - Long t (tq > 16): a block of 4 warps takes 64 query rows of one head
//   and streams key tiles of 64 rows (32 at d > 64) through a double buffer
//   in shared memory: cp.async of tile kt + 1 is issued before tile kt's
//   products.  16-byte copies where k/v bases and strides are 16-byte
//   aligned and d % 4 == 0, else 4-byte ones (chosen per launch); keys past
//   t_kv and columns past d are zero-filled, so every loop runs a fixed
//   count over d rounded up to 16/32/64/128.
// - Small t (tq <= 16, the ViT): a warp takes one whole (b*h) head and a
//   block of 4 warps four heads, each warp with its own k/v buffer and
//   __syncwarp only; [64,16,4,16] is 64 blocks, [1000,16,4,16] 1000.
// - IEEE expf/logf/division, no fast math.
//
// What is left: wgmma for QK^T, TMA instead of cp.async, a persistent grid
// (t = 512 gives 128 blocks for 132 SMs), splitting k/v once per block
// rather than per warp, and a bf16 mode (ROADMAP slice 3 item 9).  At
// long t the softmax between the two products (IEEE expf, quad shuffles)
// and the copy wait and barriers leave the tensor pipe idle part of each
// tile; overlapping one tile's softmax with the next tile's Q K^T is the
// next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16;  // query rows per warp: the mma's m
constexpr int STAGES = 2;
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;

enum Mode { FWD = 0, PARTIAL = 1 };

struct Params {
  const float* q;
  const float* k;
  const float* v;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh;
  int bh, heads, tq, tkv, d, mode;
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

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero; the low 13 bits cleared), in two integer operations: for the
// finite values here it gives the same bits as cvt.rna, whose longer SASS
// sequence made the whole kernel measurably slower.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32 (x - hi is exact in f32).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a . b in 3xTF32, a given split, b = (b0, b1) split here: big += hi.hi,
// small += lo.hi + hi.lo.  The tensor cores do not round each accumulation
// to nearest, and an addend loses bits against a large accumulator, so the
// small terms keep an accumulator of their own; the caller adds the two once
// per tile.
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(small, al, bh0, bh1);
  mma_tf32(small, ah, bl0, bl1);
  mma_tf32(big, ah, bh0, bh1);
}

template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 4 * VEC : 0;  // 0: zero-fill, nothing read
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(bytes) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(bytes) : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The threads that share a k/v buffer: the block (HPB == 1) or the warp.
template <int HPB>
__device__ __forceinline__ void group_sync() {
  if constexpr (HPB == 1) {
    __syncthreads();
  } else {
    __syncwarp();
  }
}

// Shared-memory row pitches (floats) against bank conflicts: k's is 8 mod
// 16 (a warp's 8-byte fragment loads), v's 4 mod 8 (its 4-byte ones).
template <int DMAX> __host__ __device__ constexpr int kpitch() { return DMAX + 8; }
template <int DMAX> __host__ __device__ constexpr int vpitch() { return DMAX + 4; }

// Issue the copies of key rows [k0, k0 + BK) of k and v, columns
// [0, DMAX), into Ks [BK][kpitch] and Vs [BK][vpitch], by the NTHR threads
// that share the buffer; rows past tkv and columns past d are zero-filled.
template <int BK, int DMAX, int VEC, int NTHR>
__device__ __forceinline__ void load_tile(float* Ks, float* Vs, const float* kb, const float* vb,
                                          const Params& p, int k0, int tid) {
  constexpr int CPR = DMAX / VEC;  // copies per row
#pragma unroll 1  // unrolled, its addresses take registers the products need
  for (int i = tid; i < BK * CPR; i += NTHR) {
    const int j = i / CPR, c = (i % CPR) * VEC;
    const bool in = k0 + j < p.tkv && c < p.d;
    cp_async<VEC>(Ks + j * kpitch<DMAX>() + c, in ? kb + (long long)(k0 + j) * p.skt + c : kb, in);
    cp_async<VEC>(Vs + j * vpitch<DMAX>() + c, in ? vb + (long long)(k0 + j) * p.svt + c : vb, in);
  }
}

// HPB: heads per block (1: 4 warps x 16 rows of one head; 4: a warp per
// head).  BK: key rows per tile.  DMAX: d rounded up to 16/32/64/128; the
// columns past d are zeros, so every loop over d has a fixed trip count
// (a guard on d inside the unrolled loops would cut them into basic blocks
// too small to overlap the mma chains).
// VEC: floats per cp.async (4 or 1).
template <int HPB, int BK, int DMAX, int VEC>
__global__ void __launch_bounds__(THREADS) flash_kernel(Params p) {
  constexpr int KS = DMAX / 8;          // k-steps of QK^T = n-tiles of P.V
  constexpr int NT = BK / 8;            // n-tiles of QK^T = k-steps of P.V
  // Output n-tiles per P.V pass: all of them up to d = 64, a quarter at
  // d = 128, where more tile accumulators spill.
  constexpr int OCH = DMAX <= 64 ? KS : KS / 4;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;  // the mma fragments' group / thread in group
  constexpr int KP = kpitch<DMAX>(), VP = vpitch<DMAX>();
  constexpr int STAGE = BK * (KP + VP);  // floats per stage
  const int d = p.d;

  constexpr int NTHR = HPB == 1 ? THREADS : 32;  // threads sharing a k/v buffer
  int bh, q0, gtid;
  float* buf;
  if constexpr (HPB == 1) {
    const int nq = (p.tq + WARPS * ROWS - 1) / (WARPS * ROWS);
    bh = blockIdx.x / nq;
    q0 = (blockIdx.x - bh * nq) * (WARPS * ROWS) + warp * ROWS;
    buf = smem;
    gtid = threadIdx.x;
  } else {
    bh = blockIdx.x * WARPS + warp;
    if (bh >= p.bh) return;  // the whole warp; this path never syncs the block
    q0 = 0;
    buf = smem + warp * STAGES * STAGE;
    gtid = lane;
  }
  const bool live = q0 < p.tq;  // the warp has query rows (uniform)
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int r0 = q0 + g, r1 = r0 + 8;  // this thread's two rows
  const bool in0 = r0 < p.tq, in1 = r1 < p.tq;

  // q as A fragments of each k-step: (row, 2tg) (row, 2tg + 1) per row.
  const float* qb = p.q + b * p.sqb + h * p.sqh;
  float qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int c = ks * 8 + 2 * tg;
    qf[ks][0] = in0 && c < d ? qb[r0 * p.sqt + c] : 0.f;
    qf[ks][1] = in1 && c < d ? qb[r1 * p.sqt + c] : 0.f;
    qf[ks][2] = in0 && c + 1 < d ? qb[r0 * p.sqt + c + 1] : 0.f;
    qf[ks][3] = in1 && c + 1 < d ? qb[r1 * p.sqt + c + 1] : 0.f;
  }

  // State: m and l of rows r0, r1 (l as this thread's partial sum), acc in
  // the C layout: o[n][0..1] = row r0, columns 8n + 2tg + {0, 1}; o[n][2..3]
  // the same of row r1.
  const long long s0 = (long long)bh * p.tq + r0, s1 = s0 + 8;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, o[KS][4];
#pragma unroll
  for (int n = 0; n < KS; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  if (p.mode == PARTIAL && live) {
    if (in0) {
      m[0] = p.m_in[s0];
      if (tg == 0) l[0] = p.l_in[s0];
    }
    if (in1) {
      m[1] = p.m_in[s1];
      if (tg == 0) l[1] = p.l_in[s1];
    }
#pragma unroll
    for (int n = 0; n < KS; ++n) {
      const int c = n * 8 + 2 * tg;
      if (in0 && c < d) o[n][0] = p.a_in[s0 * d + c];
      if (in0 && c + 1 < d) o[n][1] = p.a_in[s0 * d + c + 1];
      if (in1 && c < d) o[n][2] = p.a_in[s1 * d + c];
      if (in1 && c + 1 < d) o[n][3] = p.a_in[s1 * d + c + 1];
    }
  }
  __syncwarp();  // every lane has read its rows' state before any lane writes it

  const float* kb = p.k + b * p.skb + h * p.skh;
  const float* vb = p.v + b * p.svb + h * p.svh;
  const int nk = (p.tkv + BK - 1) / BK;
  load_tile<BK, DMAX, VEC, NTHR>(buf, buf + BK * KP, kb, vb, p, 0, gtid);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      float* nxt = buf + ((kt + 1) & 1) * STAGE;
      load_tile<BK, DMAX, VEC, NTHR>(nxt, nxt + BK * KP, kb, vb, p, (kt + 1) * BK, gtid);
    }
    cp_async_commit();  // possibly empty, so "all but the newest" is tile kt
    cp_async_wait_prior();
    group_sync<HPB>();
    if (live) {
      const float* Ks = buf + (kt & 1) * STAGE;
      const float* Vs = Ks + BK * KP;
      const int k0 = kt * BK;

      // S = Q K^T: s[nt] holds keys k0 + 8nt + 2tg + {0, 1} of rows r0, r1
      // (sl: the small terms, added once at the end).
      float s[NT][4], sl[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = sl[nt][e] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) split(qf[ks][i], ah[i], al[i]);
        const float* kr = Ks + g * KP + ks * 8 + 2 * tg;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float2 kk = *reinterpret_cast<const float2*>(kr + nt * 8 * KP);
          mma3(s[nt], sl[nt], ah, al, kk.x, kk.y);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] += sl[nt][e];
      }

      // Online softmax over this tile, rows r0 (e = 0, 1) and r1 (e = 2, 3).
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool key = k0 + nt * 8 + 2 * tg + (e & 1) < p.tkv;
          s[nt][e] = key ? s[nt][e] * p.scale : NEG_INF;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
        }
      }
      float corr[2], ps[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL_MASK, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL_MASK, mx[i], 2));
        mx[i] = fmaxf(m[i], mx[i]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool key = k0 + nt * 8 + 2 * tg + (e & 1) < p.tkv;
          s[nt][e] = key ? expf(s[nt][e] - mx[e >> 1]) : 0.f;
          ps[e >> 1] += s[nt][e];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        corr[i] = expf(m[i] - mx[i]);  // 1 while both are still -1e30
        l[i] = l[i] * corr[i] + ps[i];
        m[i] = mx[i];
      }

      // acc = acc * corr + P V.  P's C fragment of key n-tile j is the A
      // fragment of k-step j under the permuted reduction index: a0 = key
      // 2tg of row r0 (s[j][0]), a1 = of row r1 (s[j][2]), a2 = key 2tg + 1
      // of row r0 (s[j][1]), a3 = of row r1 (s[j][3]); b0, b1 = v rows
      // 8j + 2tg and 8j + 2tg + 1.
#pragma unroll
      for (int c0 = 0; c0 < KS; c0 += OCH) {
        float ot[OCH][4], otl[OCH][4];
#pragma unroll
        for (int n = 0; n < OCH; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) ot[n][e] = otl[n][e] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          uint32_t ah[4], al[4];
          split(s[j][0], ah[0], al[0]);
          split(s[j][2], ah[1], al[1]);
          split(s[j][1], ah[2], al[2]);
          split(s[j][3], ah[3], al[3]);
          const float* vr = Vs + (j * 8 + 2 * tg) * VP + g;
#pragma unroll
          for (int n = 0; n < OCH; ++n) {
            const int col = (c0 + n) * 8;
            mma3(ot[n], otl[n], ah, al, vr[col], vr[VP + col]);
          }
        }
#pragma unroll
        for (int n = 0; n < OCH; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            o[c0 + n][e] = fmaf(o[c0 + n][e], corr[e >> 1], ot[n][e] + otl[n][e]);
          }
        }
      }
    }
    group_sync<HPB>();  // the buffer is free for tile kt + 2
  }

  if (!live) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL_MASK, l[i], 1);
    l[i] += __shfl_xor_sync(FULL_MASK, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i == 0 ? r0 : r1;
    if (row >= p.tq) continue;
    const long long srow = i == 0 ? s0 : s1;
    if (p.mode == FWD) {
      float* orow = p.out + (((long long)b * p.tq + row) * p.heads + h) * d;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        const int c = n * 8 + 2 * tg;
        if (c < d) orow[c] = l[i] > 0.f ? o[n][2 * i] / l[i] : 0.f;
        if (c + 1 < d) orow[c + 1] = l[i] > 0.f ? o[n][2 * i + 1] / l[i] : 0.f;
      }
      if (tg == 0) p.lse[srow] = m[i] + logf(l[i] > 0.f ? l[i] : 1.f);
    } else {
      float* arow = p.a_out + srow * d;
#pragma unroll
      for (int n = 0; n < KS; ++n) {
        const int c = n * 8 + 2 * tg;
        if (c < d) arow[c] = o[n][2 * i];
        if (c + 1 < d) arow[c + 1] = o[n][2 * i + 1];
      }
      if (tg == 0) {
        p.m_out[srow] = m[i];
        p.l_out[srow] = l[i];
      }
    }
  }
}

template <int HPB, int BK, int DMAX, int VEC>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem =
      (size_t)HPB * STAGES * BK * (kpitch<DMAX>() + vpitch<DMAX>()) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<HPB, BK, DMAX, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = HPB == 1
      ? (long long)p.bh * ((p.tq + WARPS * ROWS - 1) / (WARPS * ROWS))
      : ((long long)p.bh + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_kernel<HPB, BK, DMAX, VEC><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int HPB, int BK, int DMAX>
int launch_vec(const Params& p, bool wide, cudaStream_t stream) {
  return wide ? launch<HPB, BK, DMAX, 4>(p, stream) : launch<HPB, BK, DMAX, 1>(p, stream);
}

// Key tiles: 16 rows when a warp owns a whole head (tq <= 16), else 64, and
// 32 at d > 64 to keep the accumulators in registers.
template <int HPB, int BK>
int launch_d(const Params& p, bool wide, cudaStream_t stream) {
  if (p.d <= 16) return launch_vec<HPB, BK, 16>(p, wide, stream);
  if (p.d <= 32) return launch_vec<HPB, BK, 32>(p, wide, stream);
  if (p.d <= 64) return launch_vec<HPB, BK, 64>(p, wide, stream);
  return launch_vec<HPB, BK / 2 < 16 ? 16 : BK / 2, 128>(p, wide, stream);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

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
  if (bh > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies need every k/v row start 16-byte aligned.
  const bool wide = d % 4 == 0 && aligned16(k) && aligned16(v) &&
                    (skb | skt | skh | svb | svt | svh) % 4 == 0;
  const Params p{q, k, v, sqb, sqt, sqh, skb, skt, skh, svb, svt, svh,
                 static_cast<int>(bh), heads, tq, tkv, d, mode, scale, out, lse,
                 m_in, l_in, a_in, m_out, l_out, a_out};
  return tq <= 16 ? launch_d<WARPS, 16>(p, wide, stream) : launch_d<1, 64>(p, wide, stream);
}
