// Fused SGD updates for Hopper (sm_90a), with a plain C interface (built by
// bigdl_tpu_torch/ops/_build.py with -fmad=false, bound with ctypes in
// bigdl_tpu_torch/kernels/fused_optim.py).
//
// Replaces: bigdl_tpu/kernels/fused_optim.py:_sgd_mom_kernel (K5) and
// _sgd_plain_kernel (K6), both via fused_sgd_update / _run_blocked, the
// Pallas TPU kernels of the reference.  Same functions, in the op order of
// those kernels and of optim_method.SGD.update's tree-map math:
//
//   g   = g + wd * p                   only when wd > 0     (K5 and K6)
//   vel = mu * v + (1 - dampening) * g                      (K5)
//   step = nesterov ? g + mu * vel : vel                    (K5)
//   p   = p - clr * step               (K6: p - clr * g)
//
// The caller rounds mu, 1 - dampening and wd to fp32 on the host, as
// PyTorch rounds a Python scalar in the plain version, and hands the
// step's learning rate clr as one fp32 value in device memory, so an
// update costs no host sync.  Whether wd > 0 and whether nesterov holds
// are static choices, as in the reference: each combination is its own
// instantiation.  The file is compiled with -fmad=false, so every multiply
// and add rounds on its own, as PyTorch's elementwise kernels do one op at
// a time: the result is meant to be bitwise equal to the plain PyTorch
// version on the card.
//
// Design.  One elementwise pass over one f32 leaf per launch, a
// grid-stride loop with a bounds-checked tail (the reference's padding to
// (rows, 128) tiles is a TPU layout matter).  K5 reads p, v and g once
// and writes p and v once (20 bytes an element); K6 reads p and g and
// writes p (12 bytes).
//
// What bounds it on an H100: bytes.  At most 6 FLOP an element against
// 12-20 bytes.  Over the 25,557,032 parameters of ResNet-50 that is
// 511 MB for K5 (0.153 ms at 3.35 TB/s) and 307 MB for K6 (0.092 ms).
// One launch per leaf (161 for ResNet-50, 8 for LeNet-5) adds a few
// microseconds each; a multi-tensor launch for K4, K5 and K6 is later
// work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

unsigned grid_for(int64_t n) {
    const int64_t want = (n + NT - 1) / NT;
    return unsigned(want < 132 * 16 ? want : 132 * 16);
}

template <bool DECAY, bool NESTEROV>
__global__ void __launch_bounds__(NT)
sgd_mom_kernel(float* __restrict__ p, float* __restrict__ v,
               const float* __restrict__ g, int64_t n,
               const float* __restrict__ clr_p, float mu, float omd,
               float wd) {
    const float clr = *clr_p;
    const int64_t stride = int64_t(gridDim.x) * NT;
    for (int64_t i = int64_t(blockIdx.x) * NT + threadIdx.x; i < n;
         i += stride) {
        const float pi = p[i];
        float gi = g[i];
        if (DECAY) gi = gi + wd * pi;
        const float vel = mu * v[i] + omd * gi;
        const float step = NESTEROV ? gi + mu * vel : vel;
        p[i] = pi - clr * step;
        v[i] = vel;
    }
}

template <bool DECAY>
__global__ void __launch_bounds__(NT)
sgd_plain_kernel(float* __restrict__ p, const float* __restrict__ g,
                 int64_t n, const float* __restrict__ clr_p, float wd) {
    const float clr = *clr_p;
    const int64_t stride = int64_t(gridDim.x) * NT;
    for (int64_t i = int64_t(blockIdx.x) * NT + threadIdx.x; i < n;
         i += stride) {
        const float pi = p[i];
        float gi = g[i];
        if (DECAY) gi = gi + wd * pi;
        p[i] = pi - clr * gi;
    }
}

}  // namespace

// K5.  p and v (updated in place) and g: n contiguous float32 values on
// the device; clr: one float32 in device memory; mu = momentum,
// omd = 1 - dampening, wd = weight decay (applied when decay != 0);
// nesterov != 0 takes the Nesterov step.  Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() after the launch.
extern "C" int bigdl_fused_sgd_mom(void* p, void* v, const void* g,
                                   int64_t n, const void* clr, float mu,
                                   float omd, float wd, int decay,
                                   int nesterov, void* stream) {
    if (n <= 0) return int(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    auto pp = static_cast<float*>(p);
    auto vp = static_cast<float*>(v);
    auto gp = static_cast<const float*>(g);
    auto cp = static_cast<const float*>(clr);
    const unsigned blocks = grid_for(n);
    if (decay && nesterov)
        sgd_mom_kernel<true, true><<<blocks, NT, 0, s>>>(pp, vp, gp, n, cp,
                                                         mu, omd, wd);
    else if (decay)
        sgd_mom_kernel<true, false><<<blocks, NT, 0, s>>>(pp, vp, gp, n, cp,
                                                          mu, omd, wd);
    else if (nesterov)
        sgd_mom_kernel<false, true><<<blocks, NT, 0, s>>>(pp, vp, gp, n, cp,
                                                          mu, omd, wd);
    else
        sgd_mom_kernel<false, false><<<blocks, NT, 0, s>>>(pp, vp, gp, n, cp,
                                                           mu, omd, wd);
    return int(cudaGetLastError());
}

// K6.  p (updated in place) and g: n contiguous float32 values on the
// device; clr as for K5; wd applied when decay != 0.  Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
extern "C" int bigdl_fused_sgd_plain(void* p, const void* g, int64_t n,
                                     const void* clr, float wd, int decay,
                                     void* stream) {
    if (n <= 0) return int(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    auto pp = static_cast<float*>(p);
    auto gp = static_cast<const float*>(g);
    auto cp = static_cast<const float*>(clr);
    const unsigned blocks = grid_for(n);
    if (decay)
        sgd_plain_kernel<true><<<blocks, NT, 0, s>>>(pp, gp, n, cp, wd);
    else
        sgd_plain_kernel<false><<<blocks, NT, 0, s>>>(pp, gp, n, cp, wd);
    return int(cudaGetLastError());
}
