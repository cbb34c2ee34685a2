// One-pass host prep of raw depth frames (ops/preprocess.py:
// prep_raw_frames_host), a copy of the JAX package's native/prep_native.cpp.
//
// The plain numpy version makes about 8 passes over the chunk (mask, int32
// cast, subtract, ROI multiply, vmin floor, clip, cast, sentinel scatter);
// this makes one. Built with g++ by native.py, loaded with ctypes.
//
// Bit for bit the numpy version's semantics for uint16 input and uint8
// output:
//   invalid = raw == 0
//   x       = bg - raw            (int32; bg==NULL -> x = raw)
//   x      *= roi                 (roi==NULL -> skip; any int roi values)
//   x       = x <  vmin_i ? 0 : x (has_vmin only; vmin_i = ceil(vmin))
//   x       = clip(x, lo, hi)     (hi = min(vmax, dtype_max-1))
//   out     = (uint8) x; invalid pixels -> sentinel (dtype max)
#include <cstdint>

extern "C" int prep_frames_native(
    const uint8_t* frames_base,  // base pointer at the bbox origin
    long stride_t, long stride_y,  // byte strides (x must be contiguous u16)
    const int32_t* bg,             // (h, w) contiguous or NULL
    const int32_t* roi,            // (h, w) contiguous or NULL
    long t, long h, long w,
    int has_vmin, int vmin_i,
    int lo, int hi,
    int sentinel,
    uint8_t* out)                  // (t, h, w) contiguous uint8
{
    for (long f = 0; f < t; ++f) {
        const uint8_t* fp = frames_base + f * stride_t;
        uint8_t* op = out + f * h * w;
        for (long y = 0; y < h; ++y) {
            const uint16_t* row =
                reinterpret_cast<const uint16_t*>(fp + y * stride_y);
            const int32_t* bgr = bg ? bg + y * w : nullptr;
            const int32_t* rr = roi ? roi + y * w : nullptr;
            uint8_t* orow = op + y * w;
            for (long x = 0; x < w; ++x) {
                const int v = row[x];
                int val = bgr ? (bgr[x] - v) : v;
                if (rr) val *= rr[x];
                if (has_vmin && val < vmin_i) val = 0;
                val = val < lo ? lo : (val > hi ? hi : val);
                orow[x] = static_cast<uint8_t>(v == 0 ? sentinel : val);
            }
        }
    }
    return 0;
}
