// Batched image preparation kernel (≙ the OpenCV/MKL-backed hot loop of
// transform/vision: dataset/image/BGRImgCropper.scala + HFlip.scala +
// BGRImgNormalizer.scala + BGRImgToBatch.scala collapsed into one pass).
//
// One call prepares a whole minibatch: per-image crop (given offsets) +
// optional horizontal flip + per-channel (mean, std) normalization +
// HWC(u8) -> CHW(f32) layout, parallelized over images with a simple
// thread fan-out.  Doing all four steps in a single pass over the pixels
// keeps the batch in L2 instead of materializing three intermediates the
// way the chained python transformers do.
//
// C ABI (ctypes): ip_prepare_batch.
#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" {

// in:  n images, each in_h x in_w x c, uint8, HWC, contiguous
// offs: per-image crop offsets (y, x) int32[2n]; flip: uint8[n] (0/1)
// mean/std: float[c] (std divides)
// out: n x c x crop_h x crop_w float32 (CHW)
// Returns 0 on success, -1 on bad arguments.
int ip_prepare_batch(const uint8_t* in, int n, int in_h, int in_w, int c,
                     const int32_t* offs, const uint8_t* flip,
                     const float* mean, const float* stdev,
                     int crop_h, int crop_w, float* out, int n_threads) {
    if (!in || !out || n <= 0 || c <= 0) return -1;
    if (crop_h > in_h || crop_w > in_w) return -1;
    const size_t in_img = size_t(in_h) * in_w * c;
    const size_t out_img = size_t(c) * crop_h * crop_w;
    std::vector<float> inv_std(c);
    for (int ch = 0; ch < c; ++ch)
        inv_std[ch] = stdev[ch] != 0.f ? 1.f / stdev[ch] : 1.f;

    auto work = [&](int lo, int hi) {
        for (int i = lo; i < hi; ++i) {
            const uint8_t* src = in + i * in_img;
            float* dst = out + i * out_img;
            const int oy = offs ? offs[2 * i] : 0;
            const int ox = offs ? offs[2 * i + 1] : 0;
            const bool fl = flip && flip[i];
            for (int y = 0; y < crop_h; ++y) {
                const uint8_t* row = src + (size_t(oy + y) * in_w + ox) * c;
                for (int x = 0; x < crop_w; ++x) {
                    const int sx = fl ? (crop_w - 1 - x) : x;
                    const uint8_t* px = row + size_t(sx) * c;
                    for (int ch = 0; ch < c; ++ch) {
                        dst[(size_t(ch) * crop_h + y) * crop_w + x] =
                            (float(px[ch]) - mean[ch]) * inv_std[ch];
                    }
                }
            }
        }
    };

    int threads = std::min(n_threads > 0 ? n_threads : 1, n);
    if (threads <= 1) {
        work(0, n);
        return 0;
    }
    std::vector<std::thread> pool;
    const int chunk = (n + threads - 1) / threads;
    for (int t = 0; t < threads; ++t) {
        const int lo = t * chunk;
        const int hi = std::min(n, lo + chunk);
        if (lo >= hi) break;
        pool.emplace_back(work, lo, hi);
    }
    for (auto& th : pool) th.join();
    return 0;
}

}  // extern "C"
