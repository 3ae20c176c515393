// Native data-loader core of the port: host C++, no CUDA.  The JAX
// package's csrc/fastloader.cpp (its data/native.py), with the gathers held
// to the port's numpy path byte for byte.
//
// The hot path of host-side batch assembly is gather + normalize:
//     out[i] = float(images[idx[i]]) * scale + shift
// with scale = f32(1 / (255 * std)) and shift = f32(-mean / std) as
// data/transforms.py computes them in numpy.  Each element is the f32
// product, rounded, then the f32 sum, rounded: numpy's two operations.  The
// library is built with -ffp-contract=off so that the compiler never fuses
// them into one FMA (one rounding), which -march=native allows by default and
// which moves the last bit of most values; never with -ffast-math.  The
// IDX header parser is the JAX package's as it stands.
//
// Differences from the JAX package's library:
//   - gather_normalize takes scale and shift, not mean and std;
//   - the label gather writes int64, the dtype of the port's labels;
//   - the symbols carry a prefix of their own and the library exports its
//     ABI version, so that a JAX build of the same C signatures (with other
//     semantics) is never loaded in its place.
//
// A plain C ABI for ctypes (no pybind11, no PyTorch headers).  ctypes
// releases the GIL for the call.

#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// Checked by data/native.py's get_lib before any other symbol is bound.
int tmnist_fastloader_abi(void) { return 1; }

// Parse an MNIST IDX header.  Returns 0 on success.
//   buf/len:   raw file bytes
//   out_dims:  int64[4] -> {count, rows, cols, payload_offset}
// Images (magic 2051) give rows/cols; labels (magic 2049) give rows=cols=0.
// -1: too short for its header; -2: bad dimensions or a truncated payload;
// -3: an unknown magic.
int tmnist_idx_parse_header(const uint8_t* buf, int64_t len, int64_t* out_dims) {
    if (len < 8) return -1;
    uint32_t magic = (uint32_t(buf[0]) << 24) | (uint32_t(buf[1]) << 16) |
                     (uint32_t(buf[2]) << 8) | uint32_t(buf[3]);
    // Signed 32-bit read (then widened), matching Python's struct ">i":
    // a sign-bit-set count must parse as negative and be rejected by the
    // n < 0 guards below on BOTH parsers, not accepted here as 2^31+.
    auto be32 = [&](int64_t off) {
        uint32_t u = (uint32_t(buf[off]) << 24) | (uint32_t(buf[off + 1]) << 16) |
                     (uint32_t(buf[off + 2]) << 8) | uint32_t(buf[off + 3]);
        return int64_t(int32_t(u));
    };
    if (magic == 2051) {  // images
        if (len < 16) return -1;
        int64_t n = be32(4), rows = be32(8), cols = be32(12);
        if (n < 0 || rows <= 0 || cols <= 0) return -2;
        // Overflow-safe truncation check: n*rows*cols (and even rows*cols)
        // can exceed int64 for hostile headers, so divide instead of
        // multiplying — floor(floor(a/b)/c) == floor(a/(b*c)) for
        // positive b, c.
        if ((len - 16) / rows / cols < n) return -2;
        out_dims[0] = n; out_dims[1] = rows; out_dims[2] = cols; out_dims[3] = 16;
        return 0;
    }
    if (magic == 2049) {  // labels
        int64_t n = be32(4);
        if (n < 0 || len < 8 + n) return -2;
        out_dims[0] = n; out_dims[1] = 0; out_dims[2] = 0; out_dims[3] = 8;
        return 0;
    }
    return -3;
}

// Gather + normalize a batch: for each of n indices (already bounds-checked
// and wrapped by the caller), read one pixel_count uint8 image and write
// float32 float(x) * scale + shift into out (contiguous [n, pixel_count]).
// Threaded over samples from 256 rows up, 8 threads at most.
void tmnist_gather_normalize(const uint8_t* images, const int32_t* indices, int64_t n,
                             int64_t pixel_count, float scale, float shift, float* out) {
    auto worker = [&](int64_t begin, int64_t end) {
        for (int64_t i = begin; i < end; ++i) {
            const uint8_t* src = images + int64_t(indices[i]) * pixel_count;
            float* dst = out + i * pixel_count;
            for (int64_t p = 0; p < pixel_count; ++p) {
                const float scaled = float(src[p]) * scale;  // rounded to f32
                dst[p] = scaled + shift;                     // rounded to f32
            }
        }
    };
    if (n < 256) {  // small batches: threading overhead loses
        worker(0, n);
        return;
    }
    // Asked only here: hardware_concurrency reads a file under /sys, three
    // system calls a batch that the small batches above need not pay.
    int64_t hw = std::thread::hardware_concurrency();
    int64_t nthreads = hw < 1 ? 1 : (hw > 8 ? 8 : hw);
    if (nthreads == 1) {
        worker(0, n);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (n + nthreads - 1) / nthreads;
    for (int64_t t = 0; t < nthreads; ++t) {
        int64_t begin = t * chunk;
        int64_t end = begin + chunk > n ? n : begin + chunk;
        if (begin >= end) break;
        threads.emplace_back(worker, begin, end);
    }
    for (auto& th : threads) th.join();
}

// Gather labels (uint8 -> int64) for a batch of indices.
void tmnist_gather_labels(const uint8_t* labels, const int32_t* indices, int64_t n,
                          int64_t* out) {
    for (int64_t i = 0; i < n; ++i) out[i] = int64_t(labels[indices[i]]);
}

}  // extern "C"
