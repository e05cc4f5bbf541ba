// Native Kaldi-ark feature loader: read + splice + skip + downsample-pad
// in one pass, GIL-free (called via ctypes, which releases the GIL for the
// duration of the call -- a python ThreadPoolExecutor over utterances gets
// real parallel file IO + processing).  A copy of the JAX package's
// ``native/ark_native.cpp``.
//
// Replaces the host-side hot path of SpeechDataset.__getitem__
// (data/dataset.py: kaldi_io.load_mat -> _splice_numpy -> skip -> pad),
// the counterpart of the reference's torch DataLoader worker processes
// (timit/utils/data_loader.py:148-151, num_workers).
//
// Format: uncompressed binary float matrices "\0BFM " (the format ArkWriter
// emits and Kaldi's copy-feats default); anything else returns ERR_FORMAT,
// and the dataset reads such an entry through its numpy reader.

#include <fcntl.h>
#include <unistd.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

constexpr int ERR_IO = -1;        // open/seek/read failure
constexpr int ERR_FORMAT = -2;    // not an uncompressed "BFM " matrix
constexpr int ERR_CAPACITY = -3;  // caller buffer too small

// "\0B" + "FM " + 2 x (size byte + int32 dim)
constexpr int kHeaderBytes = 15;

struct Header {
    int rows = 0;
    int cols = 0;
    long data_off = 0;  // absolute file offset of the float payload
};

int parse_header(const unsigned char* buf, long offset, Header* h) {
    if (buf[0] != 0x00 || buf[1] != 'B') return ERR_FORMAT;
    if (std::memcmp(buf + 2, "FM ", 3) != 0) return ERR_FORMAT;
    if (buf[5] != 4 || buf[10] != 4) return ERR_FORMAT;
    int32_t rows, cols;
    std::memcpy(&rows, buf + 6, 4);
    std::memcpy(&cols, buf + 11, 4);
    h->rows = rows;
    h->cols = cols;
    h->data_off = offset + kHeaderBytes;
    if (h->rows < 0 || h->cols <= 0) return ERR_FORMAT;
    return 0;
}

int read_header(FILE* f, long offset, Header* h) {
    if (std::fseek(f, offset, SEEK_SET) != 0) return ERR_IO;
    unsigned char buf[kHeaderBytes];
    if (std::fread(buf, 1, kHeaderBytes, f) != kHeaderBytes) return ERR_IO;
    return parse_header(buf, offset, h);
}

int read_header_fd(int fd, long offset, Header* h) {
    unsigned char buf[kHeaderBytes];
    if (pread(fd, buf, kHeaderBytes, offset) != kHeaderBytes) return ERR_IO;
    return parse_header(buf, offset, h);
}

// positional read loop (pread is thread-safe: no shared seek state)
int pread_full(int fd, void* dst, size_t n, long offset) {
    char* p = static_cast<char*>(dst);
    while (n > 0) {
        ssize_t got = pread(fd, p, n, offset);
        if (got <= 0) return ERR_IO;
        p += got;
        offset += got;
        n -= static_cast<size_t>(got);
    }
    return 0;
}

// shared splice/skip/pad pass over the raw frames
int process_raw(const float* raw, long rows, long cols, int left, int right,
                int skip, int downsample, float* out,
                long out_capacity_rows) {
    const int ctx = left + 1 + right;
    const long cols_out = cols * ctx;
    const long rows_skipped = (rows + skip - 1) / skip;  // == len(a[::skip])
    long rows_out = rows_skipped;
    const long rem = rows_skipped % downsample;
    if (rem) rows_out += downsample - rem;
    if (rows_out > out_capacity_rows) return ERR_CAPACITY;

    for (long r = 0; r < rows_skipped; ++r) {
        const long i = r * skip;
        float* dst = out + r * cols_out;
        for (int s = -left; s <= right; ++s) {
            long src = i + s;
            if (src < 0) src = 0;
            if (src >= rows) src = rows - 1;
            std::memcpy(dst, raw + src * cols, cols * 4);
            dst += cols;
        }
    }
    if (rows_out > rows_skipped) {
        std::memset(out + rows_skipped * cols_out, 0,
                    static_cast<size_t>(rows_out - rows_skipped) * cols_out * 4);
    }
    return static_cast<int>(rows_out);
}

}  // namespace

extern "C" {

// Peek the (rows, cols) of the matrix at `path:offset`.
// Returns 0 on success, ERR_* otherwise.
int ark_dims(const char* path, long offset, int* rows, int* cols) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return ERR_IO;
    Header h;
    int rc = read_header(f, offset, &h);
    std::fclose(f);
    if (rc != 0) return rc;
    *rows = h.rows;
    *cols = h.cols;
    return 0;
}

// Load the matrix at `path:offset`, apply edge-replicated context splicing
// (left/right frames), frame skipping (keep every `skip`-th row) and
// zero-row padding to a multiple of `downsample`, writing the processed
// (rows_out, cols*(left+1+right)) float32 matrix into `out`.
// Returns rows_out on success, ERR_* otherwise.
int ark_load_processed(const char* path, long offset, int left, int right,
                       int skip, int downsample, float* out,
                       long out_capacity_rows) {
    if (skip < 1) skip = 1;
    if (downsample < 1) downsample = 1;
    FILE* f = std::fopen(path, "rb");
    if (!f) return ERR_IO;
    Header h;
    int rc = read_header(f, offset, &h);
    if (rc != 0) {
        std::fclose(f);
        return rc;
    }
    const long rows = h.rows, cols = h.cols;
    std::vector<float> raw(static_cast<size_t>(rows) * cols);
    size_t want = static_cast<size_t>(rows) * cols;
    if (std::fread(raw.data(), 4, want, f) != want) {
        std::fclose(f);
        return ERR_IO;
    }
    std::fclose(f);
    return process_raw(raw.data(), rows, cols, left, right, skip, downsample,
                       out, out_capacity_rows);
}

// ---- fd-based API: open each ark file ONCE, then positional (pread) -----
// reads per utterance.  The preload hot path reads thousands of entries
// from a handful of big ark files; caching the fd removes the per-entry
// fopen/fclose pair, and pread needs no seek state so concurrent threads
// share one fd safely.

// Returns an fd (>= 0) or ERR_IO.
int ark_open(const char* path) {
    int fd = open(path, O_RDONLY);
    return fd < 0 ? ERR_IO : fd;
}

void ark_close(int fd) {
    if (fd >= 0) close(fd);
}

int ark_dims_fd(int fd, long offset, int* rows, int* cols) {
    Header h;
    int rc = read_header_fd(fd, offset, &h);
    if (rc != 0) return rc;
    *rows = h.rows;
    *cols = h.cols;
    return 0;
}

// Single-pass variant of ark_load_processed over a cached fd: one header
// pread + one payload pread, no fopen.
int ark_load_processed_fd(int fd, long offset, int left, int right, int skip,
                          int downsample, float* out,
                          long out_capacity_rows) {
    if (skip < 1) skip = 1;
    if (downsample < 1) downsample = 1;
    Header h;
    int rc = read_header_fd(fd, offset, &h);
    if (rc != 0) return rc;
    const long rows = h.rows, cols = h.cols;
    std::vector<float> raw(static_cast<size_t>(rows) * cols);
    rc = pread_full(fd, raw.data(), static_cast<size_t>(rows) * cols * 4,
                    h.data_off);
    if (rc != 0) return rc;
    return process_raw(raw.data(), rows, cols, left, right, skip, downsample,
                       out, out_capacity_rows);
}

}  // extern "C"
