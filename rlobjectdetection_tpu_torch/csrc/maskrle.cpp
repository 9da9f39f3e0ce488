// RLE mask core: the COCO mask API's compute kernels in C++ (a copy of the
// JAX package's native/maskrle.cpp, which the port does not import).
//
// pycocotools' C core (maskApi.{h,c}: rleEncode/rleDecode/rleMerge/rleArea/
// rleIou/bbIou/rleToBbox/rleFrBbox/rleFrPoly) on the same column-major
// uncompressed-counts RLE representation, exposed through a C ABI bound with
// ctypes (rlobjectdetection_tpu_torch/native.py). Counts alternate runs of
// 0s and 1s in column-major (Fortran) order.
//
// Build: g++ -O2 -shared -fPIC maskrle.cpp -o libmaskrle.so (native.py does
// it at first use, into rlobjectdetection_tpu_torch/build/).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Encode a column-major binary mask [h*w] into run counts.
// Returns number of counts written into `counts` (caller allocates h*w+1).
int rle_encode(const uint8_t* mask, int h, int w, uint32_t* counts) {
    long n = (long)h * w;
    int m = 0;
    uint8_t prev = 0;
    uint32_t run = 0;
    for (long i = 0; i < n; ++i) {
        uint8_t v = mask[i] ? 1 : 0;
        if (v != prev) {
            counts[m++] = run;
            run = 0;
            prev = v;
        }
        ++run;
    }
    counts[m++] = run;
    return m;
}

// Decode run counts back into a column-major binary mask.
void rle_decode(const uint32_t* counts, int m, int h, int w, uint8_t* mask) {
    long pos = 0;
    uint8_t v = 0;
    long n = (long)h * w;
    for (int i = 0; i < m; ++i) {
        uint32_t run = counts[i];
        for (uint32_t k = 0; k < run && pos < n; ++k) mask[pos++] = v;
        v = 1 - v;
    }
    while (pos < n) mask[pos++] = 0;
}

// Area (number of 1s) of an RLE.
uint64_t rle_area(const uint32_t* counts, int m) {
    uint64_t a = 0;
    for (int i = 1; i < m; i += 2) a += counts[i];
    return a;
}

// Merge two RLEs with intersect (1) or union (0) — two-pointer run walk.
// Returns count length written to `out` (caller allocates len_a+len_b+2).
int rle_merge2(const uint32_t* a, int ma, const uint32_t* b, int mb,
               int intersect, uint32_t* out) {
    // walk both run lists simultaneously
    std::vector<uint32_t> res;
    res.reserve((size_t)ma + mb);
    int ia = 0, ib = 0;
    uint64_t ra = ma > 0 ? a[0] : 0, rb = mb > 0 ? b[0] : 0;
    uint8_t va = 0, vb = 0;
    uint8_t prev = 2;  // sentinel
    uint64_t run = 0;
    while (ia < ma && ib < mb) {
        // skip zero-length runs
        while (ia < ma && ra == 0) { ++ia; va = 1 - va; ra = ia < ma ? a[ia] : 0; }
        while (ib < mb && rb == 0) { ++ib; vb = 1 - vb; rb = ib < mb ? b[ib] : 0; }
        if (ia >= ma || ib >= mb) break;
        uint64_t step = std::min(ra, rb);
        uint8_t v = intersect ? (va & vb) : (va | vb);
        if (v == prev) {
            run += step;
        } else {
            if (prev != 2) res.push_back((uint32_t)run);
            else if (v == 1) res.push_back(0);  // leading-1 mask needs a 0 run first
            prev = v;
            run = step;
        }
        ra -= step;
        rb -= step;
    }
    if (prev != 2) res.push_back((uint32_t)run);
    std::memcpy(out, res.data(), res.size() * sizeof(uint32_t));
    return (int)res.size();
}

// IoU between two RLEs (iscrowd: denominator = area of the first / "dt").
double rle_iou_pair(const uint32_t* dt, int mdt, const uint32_t* gt, int mgt,
                    int iscrowd) {
    // intersection area via merged walk
    std::vector<uint32_t> tmp((size_t)mdt + mgt + 2);
    int mi = rle_merge2(dt, mdt, gt, mgt, 1, tmp.data());
    uint64_t inter = rle_area(tmp.data(), mi);
    uint64_t ad = rle_area(dt, mdt);
    uint64_t ag = rle_area(gt, mgt);
    double denom = iscrowd ? (double)ad : (double)(ad + ag - inter);
    return denom > 0 ? (double)inter / denom : 0.0;
}

// Full RLE IoU matrix in one call: counts are packed into one flat array
// with per-mask offsets/lengths, so python pays ONE ctypes crossing per
// (image, category) cell instead of n*k (segm eval hot path).
void rle_iou_matrix(const uint32_t* dts, const int32_t* dt_off,
                    const int32_t* dt_len, int n,
                    const uint32_t* gts, const int32_t* gt_off,
                    const int32_t* gt_len, int k,
                    const uint8_t* iscrowd, double* out) {
    for (int j = 0; j < k; ++j) {
        int crowd = iscrowd != nullptr && iscrowd[j];
        for (int i = 0; i < n; ++i) {
            out[(long)i * k + j] = rle_iou_pair(
                dts + dt_off[i], dt_len[i], gts + gt_off[j], gt_len[j], crowd);
        }
    }
}

// Bounding-box IoU, xywh, crowd-aware — the bbIou of maskApi.c.
void bb_iou(const double* dt, int n, const double* gt, int k,
            const uint8_t* iscrowd, double* out) {
    for (int g = 0; g < k; ++g) {
        double gx1 = gt[g * 4], gy1 = gt[g * 4 + 1];
        double gw = gt[g * 4 + 2], gh = gt[g * 4 + 3];
        double ga = gw * gh;
        int crowd = iscrowd != nullptr && iscrowd[g];
        for (int d = 0; d < n; ++d) {
            double dx1 = dt[d * 4], dy1 = dt[d * 4 + 1];
            double dw = dt[d * 4 + 2], dh = dt[d * 4 + 3];
            double da = dw * dh;
            out[d * k + g] = 0;
            double w = std::min(dx1 + dw, gx1 + gw) - std::max(dx1, gx1);
            if (w <= 0) continue;
            double h = std::min(dy1 + dh, gy1 + gh) - std::max(dy1, gy1);
            if (h <= 0) continue;
            double inter = w * h;
            double uni = crowd ? da : da + ga - inter;
            if (uni > 0) out[d * k + g] = inter / uni;
        }
    }
}

// RLE → xywh bbox (rleToBbox).
void rle_to_bbox(const uint32_t* counts, int m, int h, int w, double* bb) {
    long xs = w, ys = h, xe = -1, ye = -1;
    long pos = 0;
    uint8_t v = 0;
    for (int i = 0; i < m; ++i) {
        uint32_t run = counts[i];
        if (v == 1 && run > 0) {
            long start = pos, end = pos + run - 1;
            long x0 = start / h, y0 = start % h;
            long x1 = end / h, y1 = end % h;
            xs = std::min(xs, x0);
            xe = std::max(xe, x1);
            if (x0 == x1) {
                ys = std::min(ys, y0);
                ye = std::max(ye, y1);
            } else {
                ys = 0;
                ye = h - 1;
            }
        }
        pos += run;
        v = 1 - v;
    }
    if (xe < 0) {
        bb[0] = bb[1] = bb[2] = bb[3] = 0;
    } else {
        bb[0] = (double)xs;
        bb[1] = (double)ys;
        bb[2] = (double)(xe - xs + 1);
        bb[3] = (double)(ye - ys + 1);
    }
}

// xywh bbox → RLE (rleFrBbox). Caller allocates 2*w+2 counts.
int rle_from_bbox(const double* bb, int h, int w, uint32_t* counts) {
    int xs = (int)bb[0];
    int ys = (int)bb[1];
    int xe = (int)(bb[0] + bb[2] - 1);
    int ye = (int)(bb[1] + bb[3] - 1);
    if (bb[2] <= 0 || bb[3] <= 0 || xe < 0 || ye < 0 || xs >= w || ys >= h) {
        // degenerate/out-of-frame box → empty mask (one all-zeros run);
        // without this, xe < xs makes the trailing-run arithmetic negative
        counts[0] = (uint32_t)((long)h * w);
        return 1;
    }
    xs = std::max(0, std::min(xs, w - 1));
    xe = std::max(0, std::min(xe, w - 1));
    ys = std::max(0, std::min(ys, h - 1));
    ye = std::max(0, std::min(ye, h - 1));
    // column-major runs: for each column in [xs, xe], rows [ys, ye] are 1
    int m = 0;
    long pos = 0;
    long first_start = (long)xs * h + ys;
    counts[m++] = (uint32_t)first_start;
    int span = ye - ys + 1;
    int gap = h - span;
    for (int x = xs; x <= xe; ++x) {
        counts[m++] = (uint32_t)span;
        if (x < xe) {
            counts[m++] = (uint32_t)gap;
        }
    }
    long used = first_start + (long)(xe - xs + 1) * span + (long)(xe - xs) * gap;
    long total = (long)h * w;
    counts[m++] = (uint32_t)(total - used);
    return m;
}

// Polygon → RLE rasterization (rleFrPoly): even-odd scanline fill on the
// upsampled-by-5 grid like maskApi (approximated with direct scanline per
// column at pixel centers for simplicity; adequate for area/IoU use).
int rle_from_poly(const double* xy, int npts, int h, int w, uint32_t* counts) {
    std::vector<uint8_t> mask((size_t)h * w, 0);
    // point-in-polygon per pixel center, column-major write
    for (int x = 0; x < w; ++x) {
        double px = x + 0.5;
        // gather crossings of polygon edges with the vertical line px
        std::vector<double> ys;
        for (int i = 0; i < npts; ++i) {
            double x0 = xy[2 * i], y0 = xy[2 * i + 1];
            double x1 = xy[2 * ((i + 1) % npts)], y1 = xy[2 * ((i + 1) % npts) + 1];
            if ((x0 <= px && x1 > px) || (x1 <= px && x0 > px)) {
                double t = (px - x0) / (x1 - x0);
                ys.push_back(y0 + t * (y1 - y0));
            }
        }
        std::sort(ys.begin(), ys.end());
        for (size_t i = 0; i + 1 < ys.size(); i += 2) {
            int y_lo = (int)std::ceil(ys[i] - 0.5);
            int y_hi = (int)std::floor(ys[i + 1] - 0.5);
            y_lo = std::max(0, y_lo);
            y_hi = std::min(h - 1, y_hi);
            for (int y = y_lo; y <= y_hi; ++y) mask[(size_t)x * h + y] = 1;
        }
    }
    return rle_encode(mask.data(), h, w, counts);
}

}  // extern "C"
