// Flash attention on the tensor cores, f32-accurate for f32 inputs and in
// the Pallas kernel's bf16 contract for bf16 ones: the online-softmax fold of
// q against streamed k/v tiles, one launch for a whole attention call or one
// ring hop.
//
// Replaces both TPU kernels of pytorch_mnist_ddp_tpu/ops/pallas_attention.py,
// which share one body (_fold_block):
//
//   mode 0 (fwd)      _fwd_kernel (via _flash_fwd): the state starts empty
//                     (m = -1e30, l = 0, acc = 0); after the last key tile
//                     it writes out = acc / l (0 where l == 0) in the input
//                     dtype and lse = m + log(l) in f32.
//   mode 1 (partial)  _partial_kernel (via _flash_partial): one ring hop.
//                     The f32 state (m, l, acc) is read, the visiting k/v
//                     block folded in, and the raw state written back.  The
//                     output pointers may equal the input ones (the TPU
//                     kernel's input_output_aliases): each warp owns its
//                     rows, reads their state before its first product and
//                     writes it after its last, so no pointer is __restrict__.
//
// Per key tile, for each query row (_fold_block's arithmetic, masked key
// columns excluded):
//
//     s     = (q . k_j) * scale               (f32 accumulation; scale = 1/sqrt(d))
//     m_new = max(m, max_j s_j)
//     p_j   = exp(s_j - m_new)                (f32; 0 for keys past t_kv)
//     l     = l * exp(m - m_new) + sum_j p_j  (the f32 p, never rounded)
//     acc   = acc * exp(m - m_new) + sum_j P_j v_j
//
// where P = p for f32 inputs and P = bf16(p) (round to nearest even) for bf16
// ones, as _fold_block rounds p to v.dtype before P.V; the bf16 output is
// acc / l (IEEE division) rounded to bf16.
//
// Layouts (JAX's, nothing padded): q, k, v [b, t, h, d] of one dtype, given by
// their (b, t, h) element strides with stride 1 along d, so the q/k/v views
// of the ViT's head-major qkv projection go in without a copy; out
// [b, tq, h, d] contiguous; lse [b, h, tq]; state m, l [b, h, tq] and acc
// [b, h, tq, d] contiguous f32 (ops/attention.py BlockAcc).  Ragged key and
// query tiles are masked by index, not by padding; any d >= 1.
//
// What bounds it on an H100 SXM.  At long t the two products: 4*b*h*t^2*d
// operations, 34 Gflop at (1, 8192, 2, 64).  f32: the tensor cores take f32
// operands only as TF32 (10-bit mantissa), and one TF32 pass misses the f32
// gate (rtol 1e-5) by 100-700x, so each product runs as 3xTF32: x = hi + lo
// with hi = tf32(x), lo = tf32(x - hi), and a.b = hi.hi + (lo.hi + hi.lo)
// (CUTLASS's OpMultiplyAddFastF32 splits the same way).  The tensor cores do
// not round each accumulation to nearest: with all three passes in one
// accumulator the row max m drifted further from an f64 reference than the
// plain f32 version's, and l, held to rtol 1e-5, inherits m's error.  So the
// small terms accumulate apart from hi.hi and join it once per tile
// (chip_smoke.py's kernel phase holds kernel and plain version against f64).
// Three passes at 495 TFLOP/s bound the call at 0.21 ms.  bf16: one
// m16n8k16 pass per product at 989 TFLOP/s, 0.035 ms.  At the ViT's shapes
// (t = 16, d = 16) the call moves 0.5-16 MB and does 0.07-1 Gflop: launch
// latency and bytes bound it (0.2-5 us).
//
// Design.
// - Products: mma.sync with f32 accumulators, m16n8k8 TF32 for f32 inputs,
//   m16n8k16 bf16 for bf16 ones (not wgmma: its TF32 B operand must be
//   K-major, which V is not, and its 64-row tiles would leave three quarters
//   idle at t = 16).  A warp owns 16 query rows: their q stays in registers
//   as A fragments.  f32: split at use, k and v split at the fragment load;
//   within each 8-wide k-step the reduction index is permuted (fragment
//   column c <-> element 2c, c + 4 <-> 2c + 1; a sum does not care), so a k
//   fragment is one 8-byte shared load.  In both dtypes P goes from the
//   score accumulators (C layout) to the A operand of P.V in registers, with
//   no shuffle or shared-memory round trip (bf16: two n-tiles of scores,
//   rounded pairwise by __float22bfloat162_rn, make one k-step's A).
// - Softmax in the C layout: each thread holds two rows (g, g + 8); row max
//   reduces over the four lanes of a quad with shuffles, the row sum l is
//   kept per thread and reduced once at the end.  Each key tile's P.V goes
//   into fresh accumulators, then acc = acc * corr + tile, so the tensor
//   cores' own accumulation never runs longer than one tile.
// - Long t (tq > 16): a block of 4 warps takes 64 query rows of one head
//   and streams key tiles of 64 rows (32 at d > 64) through a double buffer
//   in shared memory: cp.async of tile kt + 1 is issued before tile kt's
//   products.  16-byte copies where k/v bases and strides are 16-byte
//   aligned and d fills whole 16-byte chunks, else one element at a time (4-
//   byte cp.async for f32; a 2-byte load and store for bf16, which cp.async
//   cannot copy); keys past t_kv and columns past d are zero-filled, so every
//   loop runs a fixed count over d rounded up to 16/32/64/128.
// - Small t (tq <= 16, the ViT): a warp takes one whole (b*h) head and a
//   block of 4 warps four heads, each warp with its own k/v buffer and
//   __syncwarp only; [64,16,4,16] is 64 blocks, [1000,16,4,16] 1000.
// - d > 128 (flash_wide_kernel): the registers hold 128 columns of q and of
//   the output, so the block loops over the output in 128-column slabs.  For
//   each slab it runs the whole key loop, recomputing every tile's scores
//   over all of d (q's slabs reread from global memory, k's slabs staged
//   through shared memory one after another), then P.V for the slab's
//   columns.  m and l come out the same in every slab's pass and are written
//   once, after the last; all slabs of a row tile stay in one block, so the
//   in-place partial mode never reads a state another block has written.
//   Single-buffered and with no overlap: a shape past the repo's models.
// - IEEE expf/logf/division, no fast math.
//
// What is left: wgmma for QK^T, TMA instead of cp.async, a persistent grid
// (t = 512 gives 128 blocks for 132 SMs), splitting k/v once per block
// rather than per warp.  At long t the softmax between the two products
// (IEEE expf, quad shuffles) and the copy wait and barriers leave the
// tensor pipe idle part of each tile; overlapping one tile's softmax with
// the next tile's Q K^T is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16;   // query rows per warp: the mma's m
constexpr int STAGES = 2;
constexpr int SLAB = 128;  // head_dim columns held in registers at once
constexpr int WIDE_BK = 32;  // key rows per tile at d > SLAB
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL_MASK = 0xffffffffu;

enum Mode { FWD = 0, PARTIAL = 1 };
enum DType { F32 = 0, BF16 = 1 };

using bf16 = uint16_t;  // bf16 bits: no arithmetic is done on them as such

template <typename T> __host__ __device__ constexpr bool is_bf16() {
  return std::is_same<T, bf16>::value;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  long long sqb, sqt, sqh, skb, skt, skh, svb, svt, svh;
  int bh, heads, tq, tkv, d, mode;
  float scale;
  void* out;    // fwd: [b, tq, h, d], the input dtype
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

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
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

// Two bf16 as one mma operand register, lo in the low half.
__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

// (lo, hi) rounded to bf16, to nearest even.
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  const __nv_bfloat162 r = __float22bfloat162_rn(make_float2(lo, hi));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// One element (or VEC of them, 16 bytes) from global into shared memory;
// zero-filled and nothing read when !valid.
template <typename T, int VEC>
__device__ __forceinline__ void copy_elems(T* dst, const T* src, bool valid) {
  constexpr int BYTES = static_cast<int>(sizeof(T)) * VEC;
  if constexpr (BYTES == 16) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 16 : 0) : "memory");
  } else if constexpr (BYTES == 4) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
                 "r"(valid ? 4 : 0) : "memory");
  } else {
    static_assert(BYTES == 2, "a bf16 element");
    *dst = valid ? *src : T(0);  // cp.async copies 4 bytes at least
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// Shared-memory row pitches (elements) against bank conflicts.  f32: k's is
// 8 mod 16 (a warp's 8-byte fragment loads), v's 4 mod 8 (its 4-byte ones).
// bf16: both 8 mod 16 (k's 4-byte loads, rows g; v's 2-byte loads, rows 2tg),
// and a multiple of 16 bytes for the 16-byte copies.
template <typename T, int DMAX> __host__ __device__ constexpr int kpitch() { return DMAX + 8; }
template <typename T, int DMAX> __host__ __device__ constexpr int vpitch() {
  return is_bf16<T>() ? DMAX + 8 : DMAX + 4;
}

// Issue the copies of key rows [k0, k0 + BK) of k and v, columns
// [0, DMAX), into Ks [BK][kpitch] and Vs [BK][vpitch], by the NTHR threads
// that share the buffer; rows past tkv and columns past d are zero-filled.
template <typename T, int BK, int DMAX, int VEC, int NTHR>
__device__ __forceinline__ void load_tile(T* Ks, T* Vs, const T* kb, const T* vb, const Params& p,
                                          int k0, int tid) {
  constexpr int CPR = DMAX / VEC;  // copies per row
  constexpr int KP = kpitch<T, DMAX>(), VP = vpitch<T, DMAX>();
#pragma unroll 1  // unrolled, its addresses take registers the products need
  for (int i = tid; i < BK * CPR; i += NTHR) {
    const int j = i / CPR, c = (i % CPR) * VEC;
    const bool in = k0 + j < p.tkv && c < p.d;
    copy_elems<T, VEC>(Ks + j * KP + c, in ? kb + (long long)(k0 + j) * p.skt + c : kb, in);
    copy_elems<T, VEC>(Vs + j * VP + c, in ? vb + (long long)(k0 + j) * p.svt + c : vb, in);
  }
}

// Rows [k0, k0 + BK) and columns [c0, c0 + SLAB) of one of k or v into
// dst [BK][pitch] by the whole block, zero-filled past tkv and d.
template <typename T, int BK, int VEC>
__device__ __forceinline__ void load_slab(T* dst, int pitch, const T* base, long long stride,
                                          const Params& p, int k0, int c0) {
  constexpr int CPR = SLAB / VEC;
#pragma unroll 1
  for (int i = threadIdx.x; i < BK * CPR; i += THREADS) {
    const int j = i / CPR, c = (i % CPR) * VEC;
    const bool in = k0 + j < p.tkv && c0 + c < p.d;
    copy_elems<T, VEC>(dst + j * pitch + c, in ? base + (long long)(k0 + j) * stride + c0 + c : base,
                       in);
  }
}

// q's columns [c0, c0 + DMAX) of rows r0, r1 as the A fragments of QK^T,
// zero past d.  f32: per 8-wide k-step (row, 2tg) (row, 2tg + 1) per row,
// the permuted reduction index; bf16: per 16-wide k-step the m16n8k16 A
// layout, (row, 2tg..2tg+1) and (row, 2tg+8..2tg+9).
template <typename T, int DMAX> struct QFrag;
template <int DMAX> struct QFrag<float, DMAX> { float f[DMAX / 8][4]; };
template <int DMAX> struct QFrag<bf16, DMAX> { uint32_t f[DMAX / 16][4]; };

template <typename T, int DMAX>
__device__ __forceinline__ void load_q(QFrag<T, DMAX>& qf, const T* qb, long long sqt, int r0,
                                       int r1, bool in0, bool in1, int d, int c0, int tg) {
  if constexpr (is_bf16<T>()) {
    auto at = [&](int r, bool in, int c) -> bf16 { return in && c < d ? qb[r * sqt + c] : bf16(0); };
#pragma unroll
    for (int ks = 0; ks < DMAX / 16; ++ks) {
      const int c = c0 + ks * 16 + 2 * tg;
      qf.f[ks][0] = pack(at(r0, in0, c), at(r0, in0, c + 1));
      qf.f[ks][1] = pack(at(r1, in1, c), at(r1, in1, c + 1));
      qf.f[ks][2] = pack(at(r0, in0, c + 8), at(r0, in0, c + 9));
      qf.f[ks][3] = pack(at(r1, in1, c + 8), at(r1, in1, c + 9));
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < DMAX / 8; ++ks) {
      const int c = c0 + ks * 8 + 2 * tg;
      qf.f[ks][0] = in0 && c < d ? qb[r0 * sqt + c] : 0.f;
      qf.f[ks][1] = in1 && c < d ? qb[r1 * sqt + c] : 0.f;
      qf.f[ks][2] = in0 && c + 1 < d ? qb[r0 * sqt + c + 1] : 0.f;
      qf.f[ks][3] = in1 && c + 1 < d ? qb[r1 * sqt + c + 1] : 0.f;
    }
  }
}

// s += Q K^T over the DMAX columns held: s[nt] holds keys 8nt + 2tg + {0, 1}
// of the tile, rows r0 (e = 0, 1) and r1 (e = 2, 3).
template <typename T, int NT, int DMAX>
__device__ __forceinline__ void scores(float (&s)[NT][4], const QFrag<T, DMAX>& qf, const T* Ks,
                                       int g, int tg) {
  constexpr int KP = kpitch<T, DMAX>();
  if constexpr (is_bf16<T>()) {
#pragma unroll
    for (int ks = 0; ks < DMAX / 16; ++ks) {
      const T* kr = Ks + g * KP + ks * 16 + 2 * tg;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint32_t* kw = reinterpret_cast<const uint32_t*>(kr + nt * 8 * KP);
        mma_bf16(s[nt], qf.f[ks], kw[0], kw[4]);  // columns 2tg.. and 2tg + 8..
      }
    }
  } else {
    float sl[NT][4];  // the small terms, added once at the end
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sl[nt][e] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < DMAX / 8; ++ks) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(qf.f[ks][i], ah[i], al[i]);
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
  }
}

// The online softmax over one key tile starting at key k0: s becomes p (f32,
// 0 past tkv), m and l (this thread's partial sum of the unrounded p) move
// on, corr = exp(m_old - m_new) per row.
template <int NT>
__device__ __forceinline__ void online_softmax(float (&s)[NT][4], float (&m)[2], float (&l)[2],
                                               float (&corr)[2], int k0, int tkv, float scale,
                                               int tg) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool key = k0 + nt * 8 + 2 * tg + (e & 1) < tkv;
      s[nt][e] = key ? s[nt][e] * scale : NEG_INF;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    }
  }
  float ps[2] = {0.f, 0.f};
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
      const bool key = k0 + nt * 8 + 2 * tg + (e & 1) < tkv;
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
}

// acc = acc * corr + P V over the DMAX columns held, o in the C layout:
// o[n][0..1] = row r0, columns 8n + 2tg + {0, 1}; o[n][2..3] the same of r1.
template <typename T, int NT, int DMAX>
__device__ __forceinline__ void pv(float (&o)[DMAX / 8][4], const float (&s)[NT][4],
                                   const float (&corr)[2], const T* Vs, int g, int tg) {
  constexpr int KS = DMAX / 8;  // output n-tiles
  // Output n-tiles per pass: all of them up to d = 64, a quarter at d = 128,
  // where more tile accumulators spill.
  constexpr int OCH = DMAX <= 64 ? KS : KS / 4;
  constexpr int VP = vpitch<T, DMAX>();
#pragma unroll
  for (int c0 = 0; c0 < KS; c0 += OCH) {
    float ot[OCH][4];
#pragma unroll
    for (int n = 0; n < OCH; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) ot[n][e] = 0.f;
    }
    if constexpr (is_bf16<T>()) {
      // P's C fragments of key n-tiles 2j and 2j + 1, rounded to bf16, are
      // the A fragment of k-step j: a0 = keys 2tg, 2tg + 1 of row r0, a1 of
      // row r1, a2 = keys 2tg + 8, 2tg + 9 of row r0, a3 of row r1; b0 = v
      // rows 16j + 2tg, 16j + 2tg + 1 of column g, b1 rows 16j + 2tg + 8, + 9.
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        const uint32_t a[4] = {pack_rn(s[2 * j][0], s[2 * j][1]),
                               pack_rn(s[2 * j][2], s[2 * j][3]),
                               pack_rn(s[2 * j + 1][0], s[2 * j + 1][1]),
                               pack_rn(s[2 * j + 1][2], s[2 * j + 1][3])};
        const T* vr = Vs + (j * 16 + 2 * tg) * VP + g;
#pragma unroll
        for (int n = 0; n < OCH; ++n) {
          const int col = (c0 + n) * 8;
          mma_bf16(ot[n], a, pack(vr[col], vr[VP + col]),
                   pack(vr[8 * VP + col], vr[9 * VP + col]));
        }
      }
#pragma unroll
      for (int n = 0; n < OCH; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[c0 + n][e] = fmaf(o[c0 + n][e], corr[e >> 1], ot[n][e]);
      }
    } else {
      // P's C fragment of key n-tile j is the A fragment of k-step j under
      // the permuted reduction index: a0 = key 2tg of row r0 (s[j][0]), a1 =
      // of row r1 (s[j][2]), a2 = key 2tg + 1 of row r0 (s[j][1]), a3 = of
      // row r1 (s[j][3]); b0, b1 = v rows 8j + 2tg and 8j + 2tg + 1.
      float otl[OCH][4];
#pragma unroll
      for (int n = 0; n < OCH; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) otl[n][e] = 0.f;
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
}

// One output element: acc / l (0 where l == 0) in the output dtype.
__device__ __forceinline__ void store_out(float* dst, float acc, float l) {
  *dst = l > 0.f ? acc / l : 0.f;
}
__device__ __forceinline__ void store_out(bf16* dst, float acc, float l) {
  *dst = __bfloat16_as_ushort(__float2bfloat16_rn(l > 0.f ? __fdiv_rn(acc, l) : 0.f));
}

// The rows' state at the start: m, l (on lane tg == 0 only: l is summed over
// the quad at the end) and acc columns [c0, c0 + DMAX), from the empty state
// or, in partial mode, from the input state.
template <int DMAX>
__device__ __forceinline__ void init_state(const Params& p, float (&m)[2], float (&l)[2],
                                           float (&o)[DMAX / 8][4], long long s0, long long s1,
                                           bool in0, bool in1, int c0, int tg) {
  m[0] = m[1] = NEG_INF;
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  if (p.mode != PARTIAL) return;
  const int d = p.d;
  if (in0) {
    m[0] = p.m_in[s0];
    if (tg == 0) l[0] = p.l_in[s0];
  }
  if (in1) {
    m[1] = p.m_in[s1];
    if (tg == 0) l[1] = p.l_in[s1];
  }
#pragma unroll
  for (int n = 0; n < DMAX / 8; ++n) {
    const int c = c0 + n * 8 + 2 * tg;
    if (in0 && c < d) o[n][0] = p.a_in[s0 * d + c];
    if (in0 && c + 1 < d) o[n][1] = p.a_in[s0 * d + c + 1];
    if (in1 && c < d) o[n][2] = p.a_in[s1 * d + c];
    if (in1 && c + 1 < d) o[n][3] = p.a_in[s1 * d + c + 1];
  }
}

// Write the rows' result, columns [c0, c0 + DMAX): fwd out (and lse when
// last), partial acc (and m, l when last).  l is this thread's partial sum.
template <typename T, int DMAX>
__device__ __forceinline__ void write_rows(const Params& p, const float (&m)[2], const float (&lp)[2],
                                           const float (&o)[DMAX / 8][4], int b, int h, int r0,
                                           long long s0, int c0, bool last, int tg) {
  float l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = lp[i] + __shfl_xor_sync(FULL_MASK, lp[i], 1);
    l[i] += __shfl_xor_sync(FULL_MASK, l[i], 2);
  }
  const int d = p.d;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= p.tq) continue;
    const long long srow = s0 + 8 * i;
    if (p.mode == FWD) {
      T* orow = static_cast<T*>(p.out) + (((long long)b * p.tq + row) * p.heads + h) * d;
#pragma unroll
      for (int n = 0; n < DMAX / 8; ++n) {
        const int c = c0 + n * 8 + 2 * tg;
        if (c < d) store_out(orow + c, o[n][2 * i], l[i]);
        if (c + 1 < d) store_out(orow + c + 1, o[n][2 * i + 1], l[i]);
      }
      if (last && tg == 0) p.lse[srow] = m[i] + logf(l[i] > 0.f ? l[i] : 1.f);
    } else {
      float* arow = p.a_out + srow * d;
#pragma unroll
      for (int n = 0; n < DMAX / 8; ++n) {
        const int c = c0 + n * 8 + 2 * tg;
        if (c < d) arow[c] = o[n][2 * i];
        if (c + 1 < d) arow[c + 1] = o[n][2 * i + 1];
      }
      if (last && tg == 0) {
        p.m_out[srow] = m[i];
        p.l_out[srow] = l[i];
      }
    }
  }
}

// d <= 128.  HPB: heads per block (1: 4 warps x 16 rows of one head; 4: a
// warp per head).  BK: key rows per tile.  DMAX: d rounded up to
// 16/32/64/128; the columns past d are zeros, so every loop over d has a
// fixed trip count (a guard on d inside the unrolled loops would cut them
// into basic blocks too small to overlap the mma chains).  VEC: elements
// per copy (16 bytes, or one element).
template <typename T, int HPB, int BK, int DMAX, int VEC>
__global__ void __launch_bounds__(THREADS) flash_kernel(Params p) {
  constexpr int NT = BK / 8;  // n-tiles of QK^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;  // the mma fragments' group / thread in group
  constexpr int KP = kpitch<T, DMAX>(), VP = vpitch<T, DMAX>();
  constexpr int STAGE = BK * (KP + VP);  // elements per stage

  constexpr int NTHR = HPB == 1 ? THREADS : 32;  // threads sharing a k/v buffer
  int bh, q0, gtid;
  T* buf;
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

  QFrag<T, DMAX> qf;
  load_q<T, DMAX>(qf, static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh, p.sqt, r0, r1, in0, in1,
                  p.d, 0, tg);

  const long long s0 = (long long)bh * p.tq + r0, s1 = s0 + 8;
  float m[2], l[2], o[DMAX / 8][4];
  init_state<DMAX>(p, m, l, o, s0, s1, live && in0, live && in1, 0, tg);
  __syncwarp();  // every lane has read its rows' state before any lane writes it

  const T* kb = static_cast<const T*>(p.k) + b * p.skb + h * p.skh;
  const T* vb = static_cast<const T*>(p.v) + b * p.svb + h * p.svh;
  const int nk = (p.tkv + BK - 1) / BK;
  load_tile<T, BK, DMAX, VEC, NTHR>(buf, buf + BK * KP, kb, vb, p, 0, gtid);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      T* nxt = buf + ((kt + 1) & 1) * STAGE;
      load_tile<T, BK, DMAX, VEC, NTHR>(nxt, nxt + BK * KP, kb, vb, p, (kt + 1) * BK, gtid);
    }
    cp_async_commit();  // possibly empty, so "all but the newest" is tile kt
    cp_async_wait_prior();
    group_sync<HPB>();
    if (live) {
      const T* Ks = buf + (kt & 1) * STAGE;
      float s[NT][4], corr[2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      }
      scores<T, NT, DMAX>(s, qf, Ks, g, tg);
      online_softmax<NT>(s, m, l, corr, kt * BK, p.tkv, p.scale, tg);
      pv<T, NT, DMAX>(o, s, corr, Ks + BK * KP, g, tg);
    }
    group_sync<HPB>();  // the buffer is free for tile kt + 2
  }

  if (!live) return;
  write_rows<T, DMAX>(p, m, l, o, b, h, r0, s0, 0, true, tg);
}

// d > 128: 4 warps x 16 rows of one head; the output in 128-column slabs,
// each slab's pass over every key tile recomputing the scores over all of
// d.  One buffer, k's slabs then v's slab per tile.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) flash_wide_kernel(Params p) {
  constexpr int BK = WIDE_BK, NT = BK / 8;
  constexpr int KP = kpitch<T, SLAB>(), VP = vpitch<T, SLAB>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + BK * KP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int nq = (p.tq + WARPS * ROWS - 1) / (WARPS * ROWS);
  const int bh = blockIdx.x / nq;
  const int q0 = (blockIdx.x - bh * nq) * (WARPS * ROWS) + warp * ROWS;
  const bool live = q0 < p.tq;
  const int b = bh / p.heads, h = bh - b * p.heads;
  const int r0 = q0 + g, r1 = r0 + 8;
  const bool in0 = live && r0 < p.tq, in1 = live && r1 < p.tq;
  const long long s0 = (long long)bh * p.tq + r0, s1 = s0 + 8;
  const T* qb = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* kb = static_cast<const T*>(p.k) + b * p.skb + h * p.skh;
  const T* vb = static_cast<const T*>(p.v) + b * p.svb + h * p.svh;
  const int slabs = (p.d + SLAB - 1) / SLAB;
  const int nk = (p.tkv + BK - 1) / BK;

  for (int oc = 0; oc < slabs; ++oc) {
    float m[2], l[2], o[SLAB / 8][4];
    init_state<SLAB>(p, m, l, o, s0, s1, in0, in1, oc * SLAB, tg);
    __syncwarp();
    for (int kt = 0; kt < nk; ++kt) {
      float s[NT][4], corr[2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      }
      for (int sc = 0; sc < slabs; ++sc) {
        __syncthreads();  // the buffer is free
        load_slab<T, BK, VEC>(Ks, KP, kb, p.skt, p, kt * BK, sc * SLAB);
        cp_async_commit();
        cp_async_wait_all();
        __syncthreads();
        if (live) {
          QFrag<T, SLAB> qf;
          load_q<T, SLAB>(qf, qb, p.sqt, r0, r1, in0, in1, p.d, sc * SLAB, tg);
          scores<T, NT, SLAB>(s, qf, Ks, g, tg);
        }
      }
      load_slab<T, BK, VEC>(Vs, VP, vb, p.svt, p, kt * BK, oc * SLAB);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      if (live) {
        online_softmax<NT>(s, m, l, corr, kt * BK, p.tkv, p.scale, tg);
        pv<T, NT, SLAB>(o, s, corr, Vs, g, tg);
      }
    }
    __syncwarp();  // every lane of the quad has read m and l before the last write
    if (live) write_rows<T, SLAB>(p, m, l, o, b, h, r0, s0, oc * SLAB, oc == slabs - 1, tg);
  }
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

template <typename T, int HPB, int BK, int DMAX, int VEC>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = (size_t)HPB * STAGES * BK * (kpitch<T, DMAX>() + vpitch<T, DMAX>()) *
                      sizeof(T);
  const int err = set_smem(reinterpret_cast<const void*>(flash_kernel<T, HPB, BK, DMAX, VEC>), smem);
  if (err != 0) return err;
  const long long blocks = HPB == 1
      ? (long long)p.bh * ((p.tq + WARPS * ROWS - 1) / (WARPS * ROWS))
      : ((long long)p.bh + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_kernel<T, HPB, BK, DMAX, VEC><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_wide(const Params& p, cudaStream_t stream) {
  const size_t smem = (size_t)WIDE_BK * (kpitch<T, SLAB>() + vpitch<T, SLAB>()) * sizeof(T);
  const int err = set_smem(reinterpret_cast<const void*>(flash_wide_kernel<T, VEC>), smem);
  if (err != 0) return err;
  const long long blocks = (long long)p.bh * ((p.tq + WARPS * ROWS - 1) / (WARPS * ROWS));
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  flash_wide_kernel<T, VEC><<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte copies, or one element a copy.
template <typename T, int HPB, int BK, int DMAX>
int launch_vec(const Params& p, bool wide, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  return wide ? launch<T, HPB, BK, DMAX, VEC>(p, stream) : launch<T, HPB, BK, DMAX, 1>(p, stream);
}

// Key tiles: 16 rows when a warp owns a whole head (tq <= 16), else 64, and
// 32 at d > 64 to keep the accumulators in registers.
template <typename T, int HPB, int BK>
int launch_d(const Params& p, bool wide, cudaStream_t stream) {
  if (p.d <= 16) return launch_vec<T, HPB, BK, 16>(p, wide, stream);
  if (p.d <= 32) return launch_vec<T, HPB, BK, 32>(p, wide, stream);
  if (p.d <= 64) return launch_vec<T, HPB, BK, 64>(p, wide, stream);
  return launch_vec<T, HPB, BK / 2 < 16 ? 16 : BK / 2, 128>(p, wide, stream);
}

template <typename T>
int dispatch(const Params& p, bool wide, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (p.d > SLAB) {
    return wide ? launch_wide<T, VEC>(p, stream) : launch_wide<T, 1>(p, stream);
  }
  return p.tq <= 16 ? launch_d<T, WARPS, 16>(p, wide, stream) : launch_d<T, 1, 64>(p, wide, stream);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// C entry point for ctypes.  dtype 0: q, k, v and out float32; 1: bfloat16
// (the state and lse are float32 either way).  mode 0 writes out and lse
// (the state pointers may be null); mode 1 reads m_in, l_in, a_in and writes
// m_out, l_out, a_out, which may be the same buffers (out and lse may be
// null).  Strides are in elements.  The Python wrapper checks devices,
// dtypes, shapes and strides.  Returns the CUDA error code of the launch
// (0 = cudaSuccess).
extern "C" int flash_attention_launch(
    int device, int mode, int dtype, const void* q, const void* k, const void* v,
    long long sqb, long long sqt, long long sqh, long long skb, long long skt, long long skh,
    long long svb, long long svt, long long svh, int batch, int heads, int tq, int tkv, int d,
    float scale, void* out, float* lse, const float* m_in, const float* l_in,
    const float* a_in, float* m_out, float* l_out, float* a_out, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (d < 1 || tq < 1 || tkv < 1 || (mode != FWD && mode != PARTIAL) ||
      (dtype != F32 && dtype != BF16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long bh = (long long)batch * heads;
  if (bh == 0) return 0;
  if (bh > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte copies need every k/v row start 16-byte aligned and d to fill
  // whole 16-byte chunks.
  const long long vec = dtype == BF16 ? 8 : 4;
  const bool wide = d % vec == 0 && aligned16(k) && aligned16(v) &&
                    (skb | skt | skh | svb | svt | svh) % vec == 0;
  const Params p{q, k, v, sqb, sqt, sqh, skb, skt, skh, svb, svt, svh,
                 static_cast<int>(bh), heads, tq, tkv, d, mode, scale, out, lse,
                 m_in, l_in, a_in, m_out, l_out, a_out};
  return dtype == BF16 ? dispatch<bf16>(p, wide, stream) : dispatch<float>(p, wide, stream);
}
