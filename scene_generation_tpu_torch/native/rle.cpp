// COCO mask codec: RLE decode + polygon rasterization, host-side C++.
//
// Replaces the pycocotools C extension used by the reference data pipeline
// (scene_generation/data/coco.py:475-486: mask_utils.frPyObjects / merge /
// decode). Implements the public COCO RLE format:
//   * counts are run lengths of alternating 0/1 pixels in COLUMN-MAJOR
//     (Fortran) order, starting with zeros;
//   * the compressed string packs the counts as base-48 varints with 5
//     payload bits per char, a continuation bit (0x20), sign extension via
//     0x10, and delta coding from the count two positions back.
// Polygon segmentations are filled with an even-odd scanline rasterizer
// sampled at pixel centers (pycocotools rasterizes an upsampled boundary;
// equivalent up to sub-pixel boundary rounding, and downstream masks are
// resized to 32x32 and binarized anyway).
//
// Built by data/rle.py with g++ -O3 -shared -fPIC into build/native/.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <cmath>

extern "C" {

// Decode an uncompressed counts array into a row-major uint8 mask.
// Returns 0 on success, -1 if the counts overflow h*w.
int rle_decode_counts(const uint32_t* counts, int n, int h, int w,
                      uint8_t* out) {
    const long total = (long)h * w;
    long pos = 0;
    uint8_t val = 0;
    for (int i = 0; i < n; ++i) {
        long run = counts[i];
        if (pos + run > total) return -1;
        if (val) {
            for (long j = pos; j < pos + run; ++j) {
                // column-major pixel index -> row-major output
                long r = j % h, c = j / h;
                out[r * (long)w + c] = 1;
            }
        }
        pos += run;
        val = 1 - val;
    }
    return (pos == total) ? 0 : -1;
}

// Parse a compressed LEB-style counts string (pycocotools rleFrString).
// Writes up to max_n counts; returns the number parsed, or -1 on overflow.
int rle_from_string(const char* s, uint32_t* counts, int max_n) {
    int m = 0;
    long p = 0;
    while (s[p]) {
        long x = 0;
        int k = 0, more = 1;
        while (more) {
            long c = s[p] - 48;
            x |= (c & 0x1f) << (5 * k);
            more = (int)(c & 0x20);
            ++p;
            ++k;
            if (!more && (c & 0x10)) x |= -1L << (5 * k);
        }
        if (m > 2) x += (long)counts[m - 2];
        if (m >= max_n) return -1;
        counts[m++] = (uint32_t)x;
    }
    return m;
}

// Decode a compressed RLE string directly to a row-major mask.
int rle_decode(const char* s, int h, int w, uint8_t* out) {
    std::vector<uint32_t> counts((size_t)h * w + 2);
    int n = rle_from_string(s, counts.data(), (int)counts.size());
    if (n < 0) return -1;
    std::memset(out, 0, (size_t)h * w);
    return rle_decode_counts(counts.data(), n, h, w, out);
}

// Rasterize the union of polygons into a row-major mask (even-odd rule per
// polygon, sampled at pixel centers). xy: flat [x0,y0,x1,y1,...] per
// polygon, concatenated; sizes[i] = number of (x, y) PAIRS in polygon i.
int polygons_to_mask(const double* xy, const int* sizes, int n_polys,
                     int h, int w, uint8_t* out) {
    std::memset(out, 0, (size_t)h * w);
    long off = 0;
    std::vector<double> xs;
    for (int pi = 0; pi < n_polys; ++pi) {
        int n = sizes[pi];
        const double* px = xy + 2 * off;
        for (int row = 0; row < h; ++row) {
            double y = row + 0.5;
            xs.clear();
            for (int i = 0; i < n; ++i) {
                int j = (i + 1) % n;
                double y0 = px[2 * i + 1], y1 = px[2 * j + 1];
                double x0 = px[2 * i], x1 = px[2 * j];
                if ((y0 <= y && y1 > y) || (y1 <= y && y0 > y)) {
                    double t = (y - y0) / (y1 - y0);
                    xs.push_back(x0 + t * (x1 - x0));
                }
            }
            std::sort(xs.begin(), xs.end());
            for (size_t i = 0; i + 1 < xs.size(); i += 2) {
                int c0 = (int)std::ceil(xs[i] - 0.5);
                int c1 = (int)std::floor(xs[i + 1] - 0.5);
                c0 = std::max(c0, 0);
                c1 = std::min(c1, w - 1);
                for (int c = c0; c <= c1; ++c) out[(long)row * w + c] = 1;
            }
        }
        off += n;
    }
    return 0;
}

// Encode a row-major mask to uncompressed column-major counts.
// Returns number of counts written.
int rle_encode_counts(const uint8_t* mask, int h, int w, uint32_t* counts,
                      int max_n) {
    int m = 0;
    uint8_t val = 0;
    uint32_t run = 0;
    const long total = (long)h * w;
    for (long j = 0; j < total; ++j) {
        long r = j % h, c = j / h;
        uint8_t v = mask[r * (long)w + c] ? 1 : 0;
        if (v == val) {
            ++run;
        } else {
            if (m >= max_n) return -1;
            counts[m++] = run;
            val = v;
            run = 1;
        }
    }
    if (m >= max_n) return -1;
    counts[m++] = run;
    return m;
}

}  // extern "C"
