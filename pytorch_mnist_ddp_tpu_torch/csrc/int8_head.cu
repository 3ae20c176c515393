// Fused int8 dense head of the MNIST CNN: one launch from the flattened conv
// features to the pre-softmax logits.
//
// Replaces the TPU kernel pytorch_mnist_ddp_tpu/ops/pallas_infer.py:_head_kernel
// (fused_int8_head).  Per row of x:
//
//     q1 <- clip(rint(x / a1), -127, 127),   a1 = max|x| / 127 (1 if 0)
//     h  <- relu(float(q1 . W1[o]) * (a1 * s1[o]) + b1[o])       o < h
//     q2 <- clip(rint(h / a2), -127, 127),   a2 = max|h| / 127 (1 if 0)
//     y  <- float(q2 . W2[o]) * (a2 * s2[o]) + b2[o]             o < 10
//
// Arithmetic matches pytorch_mnist_ddp_tpu/models/quant.py:_int8_dense op for
// op: IEEE division (never a reciprocal multiply; build without
// --use_fast_math), round half to even (rintf), exact int32 dot products,
// int32 -> float with __int2float_rn (|acc| reaches 127*127*9216 ~ 1.5e8, past
// 2^24), and the epilogue as __fmul_rn/__fadd_rn in the reference's order so
// nvcc cannot contract it into an FMA — a 1-ulp change in h can flip a code
// of the second layer.  The split below is exact: fmaxf is order-free, so a
// row max assembled from K-slices is the whole row's; int32 sums of int8
// products are exact, so partial sums over K-slices added in any order give
// the same integer.  The output equals the plain version bit for bit.
//
// Layouts (torch's): x f32 [n, k]; W1 int8 [h, k] (one output per row, fc1
// columns in NCHW order); s1, b1 f32 [h]; W2 int8 [o, h]; s2, b2 f32 [o];
// out f32 [n, o].
//
// Bound on an H100 SXM (3.35 TB/s, 1,979 int8 TOP/s): bytes.  The head must
// read x (4nk bytes) and W1 (hk): at n = 128 ~5.9 MB or ~1.8 us, at n = 1
// W1 alone, ~0.36 us.  Its int8 operations (0.30 G at n = 128) take ~0.15 us
// at the tensor cores' rate, so latency and bytes bound it, not the
// tensor pipe.
//
// Design.  The first version ran one block of 1024 threads per 2 rows: every
// block streamed all of W1 (1.18 MB) through one SM on dp4a, after reading
// its x rows twice, one phase after another — 24-25 us at every n, the
// latency of one SM pulling W1 out of L2.  Here K is split over a thread-
// block cluster instead, and the fetch of W1 overlaps the x phase:
//
//   grid (C, ceil(n/16)), cluster (C, 1, 1).  A cluster owns a tile of
//   R = 16 rows (one mma M tile); its C blocks own K-slices of whole 32-
//   column chunks (576 columns each for k = 9216 at C = 16), the last one
//   ragged when k % 32 != 0.  The wrapper picks C per n from
//   cudaOccupancyMaxActiveClusters (int8_head_max_clusters) so the grid
//   fills the card about once; 16 is a non-portable cluster size and must
//   fit in one GPC.  A block has 8 compute warps and 8 copy warps.
//
//   1. The copy warps stream the block's [h, slice] W1 slice into shared
//      memory with 16-byte cp.async (row stride k in, pitch slice + 16
//      bytes out: no bank conflicts on the B fragments); rank 0's also
//      fetch W2.  A warp issues one such copy (a warp's 512 bytes) about
//      every 250 cycles here, so the copies need warps of their own: one
//      copy warp alone takes ~37,000 cycles for the slice, eight ~8,000
//      (tools/int8_head_phases.py); issued by the compute warps, they held
//      the x phase back.  One bulk copy (cp.async.bulk on an mbarrier) per
//      W1 row was tried first and was slower still to issue.
//   2. Meanwhile each compute warp reads its two rows of the x slice once,
//      float4 loads into registers, and takes their max|x|, which its lanes
//      store into every rank's shared memory (DSMEM: stores do not wait,
//      loads would); a cluster barrier; each block forms a1 from the C
//      partial maxima and quantizes its registers into an int8 tile laid
//      out for the mma A fragment.  Rows >= n and the ragged tail are zero
//      codes.
//   3. fc1's partial product: mma.sync m16n8k32 s8 x s8 -> s32 on the
//      tensor cores, A the codes, B W1's rows (torch's [h, k] layout is the
//      .col operand as it is), two n-tiles a compute warp.  Not wgmma: its M
//      of 64 would waste 75% at n <= 16, and the product is not the limit.
//      The partials are grouped by the rank that reduces their column (rank
//      j owns h/C columns) and sent there in 16-byte stores.
//   4. cluster.sync(); rank j sums its columns over the C slots, applies
//      fc1's epilogue and the relu, and writes h into rank 0's shared
//      memory; cluster.sync().  That barrier is each rank's last: no block
//      touches another's shared memory after it, so every block may exit
//      once past it.
//   5. Rank 0 takes each row's max|h|, requantizes (a row a warp), runs fc2
//      on dp4a from the staged W2 (one thread per (row, output)) and
//      writes out.
//
// Both quantizations multiply by the scale's reciprocal and take the IEEE
// division only within 2^-14 of a rounding tie (quant4_fast), which gives
// the division's codes at a fraction of its cost.
//
// Any shape (no upper limit of the kernel's own; h % 16 == 0, which JAX's
// h % 128 == 0 implies).  Where a block's K-slice is wider than the 1152
// columns of x its registers hold (k > 18432 at C = 16), it takes the slice
// in several K-passes of at most 1152 columns: it reads x twice, once for
// the row maxima and once per pass to quantize, and the int32 partials of
// every pass add up in the mma accumulators.  fc1's hidden columns go in
// tiles of at most 128 (one n-tile pair a compute warp): per tile, the passes
// over K, then the partials' exchange and the epilogue; the W1 buffer holds
// one (tile, pass) step at a time.  The default shape is one pass and one
// tile, the layout and steps above.  Where h, its codes and W2 would
// overflow rank 0's shared memory, h and its codes go through a global
// scratch buffer the wrapper allocates, and fc2 reads W2 from global
// memory.  k need not be a multiple of 16: x is then read a float at a time
// and W1 copied 4 or 1 bytes at a time, and zero codes past k add 0.
// ops/int8_head.py's _launch_plan mirrors the layout and the steps.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int R = 16;             // rows per cluster: one mma M tile
constexpr int WARPS = 8;          // compute warps: two rows of x each
constexpr int COPY_WARPS = 8;     // warps that copy W1
constexpr int THREADS = 32 * (WARPS + COPY_WARPS);
constexpr int ROWS_PER_WARP = R / WARPS;
constexpr int MAXC = 9;           // float4 per lane per row: a K-pass <= 1152 columns
constexpr int MAX_CLUSTER = 16;
constexpr int H_TILE = 128;       // fc1 columns per step: a pair of n-tiles a compute warp
constexpr int HEADER = 1152;      // per-row scalars, C x R maxima
constexpr float QMAX = 127.0f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// The IEEE divisions live in functions of their own: inlined at every
// call site, their slow paths made the kernel's code several times larger.

// a_max > 0 ? a_max / 127 : 1
__device__ __noinline__ float act_scale(float a_max) {
  return a_max > 0.0f ? __fdiv_rn(a_max, QMAX) : 1.0f;
}

__device__ __noinline__ float recip(float scale) { return __frcp_rn(scale); }

// clip(rint(v / scale), -127, 127) as an integer code
__device__ __forceinline__ int quant(float v, float scale) {
  float q = rintf(__fdiv_rn(v, scale));
  return __float2int_rn(fminf(fmaxf(q, -QMAX), QMAX));
}

__device__ __noinline__ char4 quant4(float4 f, float scale) {
  return make_char4(quant(f.x, scale), quant(f.y, scale), quant(f.z, scale), quant(f.w, scale));
}

// The code of y rounded half to even and clipped: adding 1.5 * 2^23
// rounds y (|y| < 2^22) to an integer in the float's last place.  Sets
// near when y is within 2^-14 of a half-integer, or is not finite.
__device__ __forceinline__ int round_code(float y, bool& near) {
  constexpr float MAGIC = 12582912.0f;  // 1.5 * 2^23, bits 0x4B400000
  const float t = __fadd_rn(y, MAGIC);
  const float d = __fsub_rn(y, __fsub_rn(t, MAGIC));  // y - rint(y), exact
  near |= !(fabsf(__fsub_rn(fabsf(d), 0.5f)) >= 0x1p-14f);
  return min(max(__float_as_int(t) - 0x4B400000, -127), 127);
}

// quant() of four values of one row, without a division: rcp is
// recip(scale) and |v| <= the row's max, so |y| = |v * rcp| <= 127.0001,
// and y is within 1.5 * 2^-23 * 127.0001 < 2.3e-5 of the rounded quotient
// v / scale.  Unless y lies within 2^-14 of a half-integer, where rint
// could differ, both round to the same integer; there the caller takes
// quant4() instead (near is set).  Division, rintf and float -> int
// conversion each run at a fraction of the ALU rate, and a branch per
// value kept the compiler from overlapping them: with them the quantize
// phase was the longest of the x phase.
__device__ __forceinline__ char4 quant4_fast(float4 f, float rcp, bool& near) {
  return make_char4(round_code(__fmul_rn(f.x, rcp), near), round_code(__fmul_rn(f.y, rcp), near),
                    round_code(__fmul_rn(f.z, rcp), near), round_code(__fmul_rn(f.w, rcp), near));
}

// acc * (a_scale * s) + b, rounded step by step
__device__ __forceinline__ float epilogue(int acc, float a_scale, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), __fmul_rn(a_scale, s)), b);
}

__device__ __forceinline__ float absmax4(float4 v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One float4 of x.  volatile: the compiler may not load it again later (it
// would, for a read-only load, rather than keep the registers live), so x
// is read once.
__device__ __forceinline__ float4 load_x(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

// One K-pass of x into registers: each compute warp's two rows, columns
// [pc0, pc0 + pcols) of the row as float4 j of lane l at 4(l + 32j); zero
// for rows past n and columns past the pass.  XVEC: x's rows are 16-byte
// aligned (k % 4 == 0), else one float at a time.
template <bool XVEC>
__device__ __forceinline__ void load_pass(float4 (&v)[ROWS_PER_WARP][MAXC], const float* x, int k,
                                          int row0, int rows, int pc0, int pcols, int warp,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp + i * WARPS;
    const float* xr = x + (size_t)(row0 + r) * k + pc0;
#pragma unroll
    for (int j = 0; j < MAXC; ++j) {
      const int c = lane + 32 * j;  // float4s
      v[i][j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if constexpr (XVEC) {
        // as float4 offsets from one base: the addresses are immediates
        if (r < rows && c < pcols / 4) v[i][j] = load_x(reinterpret_cast<const float4*>(xr) + c);
      } else if (r < rows && 4 * c < pcols) {
        v[i][j].x = xr[4 * c];
        if (4 * c + 1 < pcols) v[i][j].y = xr[4 * c + 1];
        if (4 * c + 2 < pcols) v[i][j].z = xr[4 * c + 2];
        if (4 * c + 3 < pcols) v[i][j].w = xr[4 * c + 3];
      }
    }
  }
}

// global -> shared without passing through registers (or L1), 16 or 4 bytes.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// Copy warp cw copies rows cw, cw + COPY_WARPS, ... of `rows` rows of
// `bytes` at global stride `stride` into shared memory at `pitch`, in
// `unit`-byte copies: 16 or 4 (cp.async; bytes and every row start aligned
// to it) or 1 (a load and a store).
__device__ __forceinline__ void copy_rows(int8_t* dst, int pitch, const int8_t* src,
                                          size_t stride, int rows, int bytes, int unit, int cw,
                                          int lane) {
  if (unit == 16) {
    for (int r = cw; r < rows; r += COPY_WARPS)
      for (int c = 16 * lane; c < bytes; c += 16 * 32) copy16(dst + r * pitch + c, src + r * stride + c);
  } else if (unit == 4) {
    for (int r = cw; r < rows; r += COPY_WARPS)
      for (int c = 4 * lane; c < bytes; c += 4 * 32) copy4(dst + r * pitch + c, src + r * stride + c);
  } else {
    for (int r = cw; r < rows; r += COPY_WARPS)
      for (int c = lane; c < bytes; c += 32) dst[r * pitch + c] = src[r * stride + c];
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// The compute warps alone (named barrier 1; 0 is __syncthreads).
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(32 * WARPS) : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory layout of one block, the same for every rank; mirrored by
// ops/int8_head.py (_pass_width, _smem_bytes).  The header holds a1 and a2
// per row (0, 64) and every rank's row maxima, [C][R] (128).  A step is one
// h-tile of at most H_TILE fc1 columns and one K-pass of at most pw columns.
struct Layout {
  int chunks;  // 32-column chunks of k
  int slice;   // widest K-slice, columns (a multiple of 32)
  int passes;  // K-passes per slice
  int pw;      // pass width, columns (a multiple of 32, <= 32 * 4 * MAXC)
  int pitch;   // W1 and code row pitch, bytes: pw + 16
  int ht;      // h-tile rows: min(h, H_TILE)
  int htiles;  // h-tiles
  int w1, xq, recv, part, hid, hq, w2, total;  // byte offsets, total size
};

// one_step: the shape is known to take one K-pass and one h-tile (the
// values are those computed otherwise, without two divisions).
__host__ __device__ inline Layout layout(int k, int h, int o, int cluster, bool hid_smem,
                                         bool one_step = false) {
  Layout L;
  L.chunks = (k + 31) / 32;
  L.slice = 32 * ((L.chunks + cluster - 1) / cluster);
  L.passes = one_step ? 1 : (L.slice + 128 * MAXC - 1) / (128 * MAXC);
  L.pw = one_step ? L.slice : 32 * ((L.slice / 32 + L.passes - 1) / L.passes);
  L.pitch = L.pw + 16;
  L.ht = h < H_TILE ? h : H_TILE;
  L.htiles = one_step ? 1 : (h + L.ht - 1) / L.ht;
  L.w1 = HEADER;
  L.xq = L.w1 + L.ht * L.pitch;
  L.recv = L.xq + R * L.pitch;
  L.part = L.recv + R * L.ht * 4;
  // With one h-tile, h overwrites the partials once they have been sent.
  L.hid = L.htiles == 1 ? L.part : L.part + R * L.ht * 4;
  L.hq = L.hid + R * h * 4;
  L.w2 = L.hq + R * h;
  L.total = hid_smem ? L.w2 + o * h : L.part + R * L.ht * 4;
  L.total = (L.total + 15) / 16 * 16;
  return L;
}

// HID_SMEM: h, its codes and W2 in rank 0's shared memory; else hid_g,
// hq_g are [ceil(n / R) * R, h] scratch in device memory (null otherwise).
// XVEC: x's rows are 16-byte aligned.  MULTI: more than one step (K-pass
// or h-tile).  Separate instantiations, so that shared-memory pointers stay
// known as such and the default shape's code (one step) carries no other
// path: one kernel with every path ran 0.5-1.2 us a call slower than the
// single-pass kernel at the default shape (tools/int8_head_ab.py, H100).
template <bool HID_SMEM, bool XVEC, bool MULTI>
__global__ void __launch_bounds__(THREADS)
int8_head_kernel(const float* __restrict__ x, int n, int k,
                 const int8_t* __restrict__ w1, const float* __restrict__ s1,
                 const float* __restrict__ b1, int h,
                 const int8_t* __restrict__ w2, const float* __restrict__ s2,
                 const float* __restrict__ b2, int o, float* __restrict__ out,
                 float* hid_g, int8_t* hq_g) {
  extern __shared__ __align__(128) unsigned char smem[];
  // Every block of the cluster must have started before any writes into
  // its shared memory: arrive first thing, wait once the loads are in
  // flight.
  cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(gridDim.x);  // the grid is one cluster wide
  const int rank = static_cast<int>(cluster.block_rank());
  const Layout L = layout(k, h, o, C, HID_SMEM, !MULTI);

  float* scale1 = reinterpret_cast<float*>(smem);       // [R]
  float* scale2 = reinterpret_cast<float*>(smem + 64);   // [R]
  float* rmax = reinterpret_cast<float*>(smem + 128);    // [C][R] max|x| per slice
  int8_t* w1s = reinterpret_cast<int8_t*>(smem + L.w1);  // [ht][pitch]
  int8_t* xq = reinterpret_cast<int8_t*>(smem + L.xq);   // [R][pitch]
  int* recv = reinterpret_cast<int*>(smem + L.recv);     // [C][R][ht/C] partials
  int* part = reinterpret_cast<int*>(smem + L.part);     // [C][R][ht/C], this block's

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.y * R;
  const int rows = min(R, n - row0);
  // This rank's K-slice: whole 32-column chunks, balanced over the ranks;
  // only the last slice can end inside a chunk.  Pass p of it starts at
  // c0 + p * pw (the last passes of a short slice may be empty).
  const int c0 = 32 * (rank * L.chunks / C);
  const int c1 = min(k, 32 * ((rank + 1) * L.chunks / C));
  // h, its codes and W2 as rank 0 reads them: its shared memory, or this
  // row tile's rows of the scratch and W2 in device memory.
  float* hid = HID_SMEM ? reinterpret_cast<float*>(smem + L.hid) : hid_g + (size_t)row0 * h;

  const int g = lane >> 2;
  const int t = lane & 3;
  const int8_t* arow = xq + g * L.pitch + 4 * t;

  const int passes = MULTI ? L.passes : 1;
  for (int step = 0; step < (MULTI ? L.htiles * passes : 1); ++step) {
    const int tile = step / passes, ps = step % passes;
    const int h0 = tile * L.ht, hrows = min(L.ht, h - h0);
    const int pc0 = min(c1, c0 + ps * L.pw);
    const int pcols = min(c1, pc0 + L.pw) - pc0;
    const int colsp = (pcols + 31) & ~31;  // the mma's reach
    if (warp >= WARPS) {
      // 1. The copy warps: they write no remote memory before the row
      // maxima's barrier, so they arrive there at once, then stream the
      // step's W1 (and, on rank 0, W2) in.  A warp issues a 16-byte
      // cp.async about every 250 cycles here, so the copies take warps of
      // their own (one alone took ~37,000 cycles for W1's slice); the
      // compute warps run the x phase meanwhile.
      if (step == 0) {
        cluster_wait();
        cluster_arrive();
      }
      const int unit = (reinterpret_cast<uintptr_t>(w1) & 15) == 0 && k % 16 == 0 ? 16
                       : (reinterpret_cast<uintptr_t>(w1) & 3) == 0 && k % 4 == 0 ? 4 : 1;
      copy_rows(w1s, L.pitch, w1 + (size_t)h0 * k + pc0, k, hrows, pcols, unit, warp - WARPS,
                lane);
      if (HID_SMEM && step == 0 && rank == 0) {
        copy_rows(reinterpret_cast<int8_t*>(smem + L.w2), h, w2, h, o, h, 16, warp - WARPS, lane);
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      if (step == 0) cluster_wait();
    } else {
      float4 v[ROWS_PER_WARP][MAXC];
      if (step == 0) {
        // 2. x: each compute warp takes its two rows' max|x| over the
        // slice, pass by pass (the last pass's loads in flight across the
        // wait for the cluster's start), and stores it into every rank's
        // shared memory.  With one pass the registers keep the slice.
        float mx[ROWS_PER_WARP] = {};
        for (int p = 0; p < passes; ++p) {
          if (p > 0) {
#pragma unroll
            for (int i = 0; i < ROWS_PER_WARP; ++i) {
#pragma unroll
              for (int j = 0; j < MAXC; ++j) mx[i] = fmaxf(mx[i], absmax4(v[i][j]));
            }
          }
          const int q0 = min(c1, c0 + p * L.pw);
          load_pass<XVEC>(v, x, k, row0, rows, q0, min(c1, q0 + L.pw) - q0, warp, lane);
        }
        cluster_wait();
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
          const int r = warp + i * WARPS;
          float m = mx[i];
#pragma unroll
          for (int j = 0; j < MAXC; ++j) m = fmaxf(m, absmax4(v[i][j]));
          m = warp_max(m);
          if (lane < C) cluster.map_shared_rank(rmax, lane)[rank * R + r] = m;
        }
        cluster_arrive();
        cluster_wait();
        if (tid < R) {
          float a = 0.0f;
          for (int j = 0; j < C; ++j) a = fmaxf(a, rmax[j * R + tid]);
          scale1[tid] = act_scale(a);
        }
        compute_sync();
      }
      if (passes > 1) load_pass<XVEC>(v, x, k, row0, rows, pc0, pcols, warp, lane);
      if (step == 0 || passes > 1) {
        // Quantize the pass into the A tile: rows >= n and columns past
        // the pass are zero codes.
#pragma unroll
        for (int i = 0; i < ROWS_PER_WARP; ++i) {
          const int r = warp + i * WARPS;
          char4* qr = reinterpret_cast<char4*>(xq + r * L.pitch);
          if (r >= rows) {
            for (int c = lane; c < colsp / 4; c += 32) qr[c] = make_char4(0, 0, 0, 0);
            continue;
          }
          const float sc = scale1[r];
          const float rc = recip(sc);
          unsigned near_tie = 0;  // float4s within 2^-14 of a tie, by j
#pragma unroll
          for (int j = 0; j < MAXC; ++j) {
            const int c = lane + 32 * j;
            bool near = false;
            const char4 q = quant4_fast(v[i][j], rc, near);  // zero past the pass
            if (c < colsp / 4) qr[c] = q;
            near_tie |= static_cast<unsigned>(near && c < colsp / 4) << j;
          }
          if (near_tie) {
#pragma unroll
            for (int j = 0; j < MAXC; ++j)
              if (near_tie >> j & 1) qr[lane + 32 * j] = quant4(v[i][j], sc);
          }
        }
      }
    }
    __syncthreads();  // the step's W1 has landed, the codes are written

    // 3. fc1's partial product on the tensor cores, a pair of n-tiles a
    // compute warp so that four accumulator chains overlap.  The partials
    // are grouped by the rank that reduces their column (rank j owns
    // hrows/C columns), summed over the passes in place.
    const int share = hrows / C;
    if (warp < WARPS && warp < hrows / 16) {
      // [n-tile][k-step parity]: four independent accumulator chains
      int acc[2][2][4] = {};
      const int8_t* brow = w1s + (warp * 16 + g) * L.pitch + 4 * t;
      auto kstep = [&](int ks, int par) {
        const int kk = 32 * ks;
        const uint32_t a[4] = {
            *reinterpret_cast<const uint32_t*>(arow + kk),
            *reinterpret_cast<const uint32_t*>(arow + 8 * L.pitch + kk),
            *reinterpret_cast<const uint32_t*>(arow + kk + 16),
            *reinterpret_cast<const uint32_t*>(arow + 8 * L.pitch + kk + 16)};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int8_t* b = brow + u * 8 * L.pitch + kk;
          mma_s8(acc[u][par], a, *reinterpret_cast<const uint32_t*>(b),
                 *reinterpret_cast<const uint32_t*>(b + 16));
        }
      };
      const int ksteps = colsp / 32;
      int ks = 0;
      for (; ks + 1 < ksteps; ks += 2) {
        kstep(ks, 0);
        kstep(ks + 1, 1);
      }
      if (ks < ksteps) kstep(ks, 0);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int r = g + 8 * ((e >> 1) & 1);
        const int col = warp * 16 + 8 * (e >> 2) + 2 * t + (e & 1);
        int* dst = part + (col / share) * R * share + r * share + col % share;
        const int sum = acc[e >> 2][0][e & 3] + acc[e >> 2][1][e & 3];
        if (ps == 0) {
          *dst = sum;
        } else {
          *dst += sum;
        }
      }
    }
    __syncthreads();  // W1's buffer and the codes are free for the next step
    if (ps + 1 < passes) continue;
    // The h-tile's partials are complete: each rank's share goes there in
    // 16-byte stores; single remote 4-byte stores cost more than the product.
    const int per_rank4 = R * share / 4;  // int4s each rank receives from this one
    for (int i = tid; i < R * hrows / 4; i += THREADS) {
      const int owner = i / per_rank4;
      reinterpret_cast<int4*>(cluster.map_shared_rank(recv, owner))[rank * per_rank4 + i % per_rank4] =
          reinterpret_cast<const int4*>(part)[i];
    }
    cluster.sync();

    // 4. Sum this rank's columns over the C slots; h goes to rank 0 (or
    // the scratch).
    float* hid0 = HID_SMEM ? cluster.map_shared_rank(hid, 0) : hid;
    for (int e = tid; e < R * share; e += THREADS) {
      const int r = e / share;
      const int col = h0 + rank * share + e % share;
      int sum = 0;
      for (int j = 0; j < C; ++j) sum += recv[j * R * share + e];
      hid0[r * h + col] = fmaxf(epilogue(sum, scale1[r], s1[col], b1[col]), 0.0f);
    }
    if constexpr (!HID_SMEM) __threadfence();
    // The last h-tile's barrier is each rank's last access to another
    // block's shared memory, so every block may exit once past it;
    // before, it frees recv, part and the W1 buffer for the next tile.
    cluster.sync();
  }
  if (rank != 0) return;

  // 5. Rank 0: requantize h per row, then fc2 and its epilogue.
  int8_t* hq = HID_SMEM ? reinterpret_cast<int8_t*>(smem + L.hq) : hq_g + (size_t)row0 * h;
  const int8_t* w2r = HID_SMEM ? reinterpret_cast<const int8_t*>(smem + L.w2) : w2;
  for (int r = warp; r < rows; r += THREADS / 32) {  // a row a warp
    const float* hr = hid + r * h;
    float mm = 0.0f;
    for (int c = lane; c < h; c += 32) mm = fmaxf(mm, fabsf(hr[c]));
    const float sc = act_scale(warp_max(mm));
    const float rc = recip(sc);
    if (lane == 0) scale2[r] = sc;
    for (int c = lane; c < h / 4; c += 32) {
      const float4 f = reinterpret_cast<const float4*>(hr)[c];
      bool near = false;
      const char4 q = quant4_fast(f, rc, near);
      reinterpret_cast<char4*>(hq + r * h)[c] = near ? quant4(f, sc) : q;
    }
  }
  __syncthreads();
  for (int p = tid; p < rows * o; p += THREADS) {
    const int r = p / o;
    const int oo = p % o;
    const int4* a = reinterpret_cast<const int4*>(hq + r * h);
    const int4* b = reinterpret_cast<const int4*>(w2r + (size_t)oo * h);
    int acc2 = 0;
    for (int c = 0; c < h / 16; ++c) {
      const int4 av = a[c];
      const int4 bv = b[c];
      acc2 = __dp4a(av.x, bv.x, acc2);
      acc2 = __dp4a(av.y, bv.y, acc2);
      acc2 = __dp4a(av.z, bv.z, acc2);
      acc2 = __dp4a(av.w, bv.w, acc2);
    }
    out[(size_t)(row0 + r) * o + oo] = epilogue(acc2, scale2[r], s2[oo], b2[oo]);
  }
}

// Raise the block's dynamic shared memory limit, and allow clusters of 16,
// once per device and instantiation for the largest size asked for.
template <bool HID_SMEM, bool XVEC, bool MULTI>
cudaError_t configure(int device, int cluster, int smem) {
  static int smem_set[64];
  static bool nonportable_set[64];
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (smem > smem_set[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        int8_head_kernel<HID_SMEM, XVEC, MULTI>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    smem_set[device] = smem;
  }
  if (cluster > 8 && !nonportable_set[device]) {
    cudaError_t err = cudaFuncSetAttribute(
        int8_head_kernel<HID_SMEM, XVEC, MULTI>, cudaFuncAttributeNonPortableClusterSizeAllowed,
        1);
    if (err != cudaSuccess) return err;
    nonportable_set[device] = true;
  }
  return cudaSuccess;
}

cudaLaunchConfig_t launch_config(int cluster, int tiles, int smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, tiles, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool HID_SMEM, bool XVEC, bool MULTI>
int launch(int device, const float* x, int n, int k, const int8_t* w1, const float* s1,
           const float* b1, int h, const int8_t* w2, const float* s2, const float* b2, int o,
           float* out, int cluster, int smem, float* hid_g, int8_t* hq_g, cudaStream_t stream) {
  cudaError_t err = configure<HID_SMEM, XVEC, MULTI>(device, cluster, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(cluster, (n + R - 1) / R, smem, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, int8_head_kernel<HID_SMEM, XVEC, MULTI>, x, n, k, w1, s1, b1,
                           h, w2, s2, b2, o, out, hid_g, hq_g);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// How many clusters of `cluster` blocks, each with `smem` bytes of dynamic
// shared memory, the card can run at once (cudaOccupancyMaxActiveClusters;
// asked of the default shape's instantiation: the others use as many
// registers, 128 a thread, one block an SM); 0 in *count when none fits.
// Returns the CUDA error code.
extern "C" int int8_head_max_clusters(int device, int cluster, int smem, int* count) {
  *count = 0;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = configure<true, true, false>(device, cluster, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(cluster, 1, smem, 0, &attr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(count, int8_head_kernel<true, true, false>, &cfg));
}

// C entry point for ctypes.  Shapes and the plan (cluster size, bytes of
// shared memory, whether h goes through the scratch hid_g / hq_g) come from
// ops/int8_head.py, which checks them (h % 16 == 0, 16-byte aligned W2,
// scales and biases, a cluster no wider than k's 32-column chunks).
// Returns the CUDA error code of the launch (0 = cudaSuccess).
extern "C" int int8_head_launch(int device, const float* x, int n, int k,
                                const int8_t* w1, const float* s1, const float* b1, int h,
                                const int8_t* w2, const float* s2, const float* b2, int o,
                                float* out, int cluster, int smem, float* hid_g, int8_t* hq_g,
                                cudaStream_t stream) {
  if (cluster < 1 || cluster > MAX_CLUSTER || (cluster & (cluster - 1)) || h % 16 ||
      cluster > (k + 31) / 32 || (hid_g == nullptr) != (hq_g == nullptr) ||
      smem != layout(k, h, o, cluster, hid_g == nullptr).total)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool xvec = k % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const Layout L = layout(k, h, o, cluster, hid_g == nullptr);
  // h through device memory only past rank 0's shared memory, which takes
  // several h-tiles
  decltype(&launch<true, true, false>) fn;
  if (hid_g != nullptr) {
    fn = xvec ? launch<false, true, true> : launch<false, false, true>;
  } else if (L.passes > 1 || L.htiles > 1) {
    fn = xvec ? launch<true, true, true> : launch<true, false, true>;
  } else {
    fn = xvec ? launch<true, true, false> : launch<true, false, false>;
  }
  return fn(device, x, n, k, w1, s1, b1, h, w2, s2, b2, o, out, cluster, smem, hid_g, hq_g,
            stream);
}
