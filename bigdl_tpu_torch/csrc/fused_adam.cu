// Fused Adam / AdamW update for Hopper (sm_90a), with a plain C interface
// (built by bigdl_tpu_torch/ops/_build.py with -fmad=false, bound with
// ctypes in bigdl_tpu_torch/kernels/fused_optim.py).
//
// Replaces: bigdl_tpu/kernels/fused_optim.py:_adam_kernel (K4, via
// fused_adam_update / _run_blocked), the Pallas TPU kernel of the
// reference.  Same function, in the op order of _adam_kernel and
// optim_method.Adam.update:
//
//   m = b1 * m + (1 - b1) * g
//   v = b2 * v + (1 - b2) * g * g            ((1 - b2) * g) * g
//   p = p - clr * (m / bc1) / (sqrt(v / bc2) + eps)
//   p = p - clr * wd * p_old                 AdamW only, (clr * wd) * p_old
//
// The caller computes b1, 1 - b1, b2, 1 - b2, eps and wd on the host as
// the plain version does (Python doubles rounded to fp32), and hands the
// step-dependent clr, bc1 and bc2 as fp32 scalars in device memory, so a
// step costs no host sync.  The file is compiled with -fmad=false and
// nvcc's default IEEE division and square root: every operation rounds on
// its own, as PyTorch's elementwise kernels do one op at a time, so the
// result is meant to be bitwise equal to the plain PyTorch version on the
// card.
//
// Design.  One elementwise pass over one f32 leaf per launch (the
// reference's padding to (rows, 128) tiles is a TPU layout matter: here a
// grid-stride loop bounds-checks its tail).  Each element reads p, m, v
// and g once and writes p, m and v once.
//
// What bounds it on an H100: bytes.  28 bytes an element against ~13
// FLOP; over the 162,417,408 parameters of TransformerLM base that is
// 4.55 GB, ~1.36 ms at 3.35 TB/s.  One launch per leaf (111 for base)
// adds a few microseconds each; a multi-tensor launch is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT)
adam_kernel(float* __restrict__ p, float* __restrict__ m,
            float* __restrict__ v, const float* __restrict__ g, int64_t n,
            const float* __restrict__ clr_p, const float* __restrict__ bc1_p,
            const float* __restrict__ bc2_p, float b1, float omb1, float b2,
            float omb2, float eps, float wd, int decay) {
    const float clr = *clr_p;
    const float bc1 = *bc1_p;
    const float bc2 = *bc2_p;
    const int64_t stride = int64_t(gridDim.x) * NT;
    for (int64_t i = int64_t(blockIdx.x) * NT + threadIdx.x; i < n;
         i += stride) {
        const float gi = g[i];
        const float pi = p[i];
        const float mi = b1 * m[i] + omb1 * gi;
        const float vi = b2 * v[i] + omb2 * gi * gi;
        float np = pi - clr * (mi / bc1) / (sqrtf(vi / bc2) + eps);
        if (decay) np = np - clr * wd * pi;
        p[i] = np;
        m[i] = mi;
        v[i] = vi;
    }
}

}  // namespace

// p, m, v (updated in place) and g: n contiguous float32 values on the
// device; clr, bc1, bc2: one float32 each in device memory.  decay != 0
// applies AdamW's decoupled weight decay wd.  Launches on `stream`, does
// not synchronise, and returns cudaGetLastError() after the launch.
extern "C" int bigdl_fused_adam(void* p, void* m, void* v, const void* g,
                                int64_t n, const void* clr, const void* bc1,
                                const void* bc2, float b1, float omb1,
                                float b2, float omb2, float eps, float wd,
                                int decay, void* stream) {
    if (n <= 0) return int(cudaErrorInvalidValue);
    const int64_t want = (n + NT - 1) / NT;
    const unsigned blocks = unsigned(want < 132 * 16 ? want : 132 * 16);
    adam_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(p), static_cast<float*>(m),
        static_cast<float*>(v), static_cast<const float*>(g), n,
        static_cast<const float*>(clr), static_cast<const float*>(bc1),
        static_cast<const float*>(bc2), b1, omb1, b2, omb2, eps, wd, decay);
    return int(cudaGetLastError());
}
