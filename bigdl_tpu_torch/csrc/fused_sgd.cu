// Fused SGD updates for Hopper (sm_90a), with a plain C interface (built by
// bigdl_tpu_torch/ops/_build.py with -fmad=false, bound with ctypes in
// bigdl_tpu_torch/kernels/fused_optim.py).
//
// Replaces: bigdl_tpu/kernels/fused_optim.py:174 _sgd_mom_kernel (K5) and
// :186 _sgd_plain_kernel (K6), both reached through fused_sgd_update and
// _run_blocked (:110), the Pallas TPU kernels of the reference.  Same
// functions, in the op order of those kernels and of optim_method.SGD.
// update's tree-map math:
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
// a time: the result is bitwise equal to the plain PyTorch version.
//
// What bounds it on an H100: bytes.  At most 6 FLOP an element against
// 20 bytes (K5: p, v, g read, p, v written) or 12 (K6).  Over the
// 25,557,032 parameters of ResNet-50 that is 511 MB for K5 (0.153 ms at
// 3.35 TB/s) and 307 MB for K6 (0.092 ms).  Most leaves of a model are
// small (106 of ResNet-50's 161 are batch-norm vectors of at most 2048
// values), so a launch per leaf pays a launch and a host call for a few
// kilobytes each.
//
// Design: one multi-tensor launch per update over a LeafTable of p, g and
// v (csrc/multi_tensor.cuh: the table, the chunked grid, the float4 and
// scalar paths, the channels-last map).  A batch-norm vector is one block;
// fc's 2048x1000 weight is 500 blocks; ResNet-50 as a whole is about 6,300
// blocks, some six waves of the card's resident blocks.  Each thread's
// loads (__ldcs: every byte is touched once) are all made before any
// arithmetic; p and v stay vectorised under a channels-last g, which is
// gathered with scalar loads.
//
// bfloat16 leaves (p, g and v all bfloat16) take their own instantiations
// (bigdl_fused_sgd_mom_bf16, bigdl_fused_sgd_plain_bf16), the reference's
// per-leaf math for a leaf that is not float32
// (bigdl_tpu/kernels/fused_optim.py:204-212, :219-224): the velocity in
// bfloat16, each operation's float result rounded to bfloat16 as
// PyTorch's eager ops round it, with mu, omd and wd rounded to bfloat16
// by the wrapper, as JAX rounds the reference's weakly typed scalars, and
// clr rounded to bfloat16 here before it scales the step.  The wrapper
// sends each dtype's leaves to its own launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "multi_tensor.cuh"

namespace {

using mt::CHUNK;
using mt::NT;
using mt::VPT;
using mt::cl_index;
constexpr int CAP = 720;                    // leaves a launch

using LeafTable = mt::LeafTable<3, CAP>;    // p, g, v (K6: v unused)
// the table plus clr, mu, 1 - dampening and wd within sm_90's kernel
// parameters
static_assert(sizeof(LeafTable) + sizeof(void*) + 3 * sizeof(float)
                  <= mt::PARAM_BYTES,
              "LeafTable exceeds the kernel parameter space");

// One element in the op order of the plain version, each result rounded
// to T as PyTorch rounds each op on a T tensor (E::rd; the identity for
// float).  clr is rounded to T first, as the plain version casts it.
template <typename T, bool MOM, bool DECAY, bool NESTEROV>
__device__ __forceinline__ void update(float& p, float& v, float g,
                                       float clr, float mu, float omd,
                                       float wd) {
    using E = mt::Elem<T>;
    if (DECAY) g = E::rd(g + E::rd(wd * p));
    if (MOM) {
        const float vel = E::rd(E::rd(mu * v) + E::rd(omd * g));
        const float step = NESTEROV ? E::rd(g + E::rd(mu * vel)) : vel;
        p = E::rd(p - E::rd(clr * step));
        v = vel;
    } else {
        p = E::rd(p - E::rd(clr * g));
    }
}

template <typename T, bool MOM, bool DECAY, bool NESTEROV>
__device__ __forceinline__ void chunk_update(const LeafTable& t,
                                             const float* __restrict__ clr_p,
                                             float mu, float omd, float wd) {
    using E = mt::Elem<T>;
    const mt::Chunk c = mt::find_chunk(t);
    const int lo = c.leaf, len = c.len;
    const int64_t off = c.off;
    T* __restrict__ p = reinterpret_cast<T*>(t.ptr[0][lo]) + off;
    const T* __restrict__ g = reinterpret_cast<const T*>(t.ptr[1][lo]);
    T* __restrict__ v = MOM ? reinterpret_cast<T*>(t.ptr[2][lo]) + off
                            : nullptr;
    const uint32_t cin = uint32_t(t.cin[lo]), hw = uint32_t(t.hw[lo]);
    const float clr = E::rd(*clr_p);

    if (t.vec[lo]) {
        const int nv = len >> 2;
        float4 pv[VPT], vv[VPT], gv[VPT];
#pragma unroll
        for (int k = 0; k < VPT; ++k) {
            const int j = threadIdx.x + k * NT;
            if (j < nv) {
                pv[k] = E::ld4(p, j);
                vv[k] = MOM ? E::ld4(v, j) : make_float4(0.f, 0.f, 0.f, 0.f);
                if (cin == 0) {
                    gv[k] = E::ld4(g + off, j);
                } else {
                    const uint32_t e = uint32_t(off) + 4u * uint32_t(j);
                    gv[k].x = E::ld(g, cl_index(e, cin, hw));
                    gv[k].y = E::ld(g, cl_index(e + 1, cin, hw));
                    gv[k].z = E::ld(g, cl_index(e + 2, cin, hw));
                    gv[k].w = E::ld(g, cl_index(e + 3, cin, hw));
                }
            }
        }
#pragma unroll
        for (int k = 0; k < VPT; ++k) {
            const int j = threadIdx.x + k * NT;
            if (j < nv) {
                update<T, MOM, DECAY, NESTEROV>(pv[k].x, vv[k].x, gv[k].x,
                                                clr, mu, omd, wd);
                update<T, MOM, DECAY, NESTEROV>(pv[k].y, vv[k].y, gv[k].y,
                                                clr, mu, omd, wd);
                update<T, MOM, DECAY, NESTEROV>(pv[k].z, vv[k].z, gv[k].z,
                                                clr, mu, omd, wd);
                update<T, MOM, DECAY, NESTEROV>(pv[k].w, vv[k].w, gv[k].w,
                                                clr, mu, omd, wd);
                E::st4(p, j, pv[k]);
                if (MOM) E::st4(v, j, vv[k]);
            }
        }
        // the ragged tail of a leaf's last chunk: at most 3 elements
        const int e = (nv << 2) + threadIdx.x;
        if (e < len) {
            float pe = E::ld(p, e), ve = MOM ? E::ld(v, e) : 0.f;
            const float ge = cin == 0
                ? E::ld(g, off + e)
                : E::ld(g, cl_index(uint32_t(off + e), cin, hw));
            update<T, MOM, DECAY, NESTEROV>(pe, ve, ge, clr, mu, omd, wd);
            E::st(p, e, pe);
            if (MOM) E::st(v, e, ve);
        }
    } else {
        for (int e = threadIdx.x; e < len; e += NT) {
            float pe = E::ld(p, e), ve = MOM ? E::ld(v, e) : 0.f;
            const float ge = cin == 0
                ? E::ld(g, off + e)
                : E::ld(g, cl_index(uint32_t(off + e), cin, hw));
            update<T, MOM, DECAY, NESTEROV>(pe, ve, ge, clr, mu, omd, wd);
            E::st(p, e, pe);
            if (MOM) E::st(v, e, ve);
        }
    }
}

template <typename T, bool DECAY, bool NESTEROV>
__global__ void __launch_bounds__(NT)
sgd_mom_kernel(const __grid_constant__ LeafTable t,
               const float* __restrict__ clr, float mu, float omd,
               float wd) {
    chunk_update<T, true, DECAY, NESTEROV>(t, clr, mu, omd, wd);
}

template <typename T, bool DECAY>
__global__ void __launch_bounds__(NT)
sgd_plain_kernel(const __grid_constant__ LeafTable t,
                 const float* __restrict__ clr, float wd) {
    chunk_update<T, false, DECAY, false>(t, clr, 0.f, 0.f, wd);
}

template <typename T>
int launch_mom(const int64_t* ptrs, const int64_t* meta, int count,
               const void* clr, float mu, float omd, float wd, int decay,
               int nesterov, void* stream) {
    LeafTable t;
    const int64_t chunks = mt::fill(t, ptrs, meta, count, 3);
    if (chunks <= 0) return int(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    auto cp = static_cast<const float*>(clr);
    const unsigned blocks = unsigned(chunks);
    if (decay && nesterov)
        sgd_mom_kernel<T, true, true><<<blocks, NT, 0, s>>>(t, cp, mu, omd,
                                                            wd);
    else if (decay)
        sgd_mom_kernel<T, true, false><<<blocks, NT, 0, s>>>(t, cp, mu, omd,
                                                             wd);
    else if (nesterov)
        sgd_mom_kernel<T, false, true><<<blocks, NT, 0, s>>>(t, cp, mu, omd,
                                                             wd);
    else
        sgd_mom_kernel<T, false, false><<<blocks, NT, 0, s>>>(t, cp, mu,
                                                              omd, wd);
    return int(cudaGetLastError());
}

template <typename T>
int launch_plain(const int64_t* ptrs, const int64_t* meta, int count,
                 const void* clr, float wd, int decay, void* stream) {
    LeafTable t;
    const int64_t chunks = mt::fill(t, ptrs, meta, count, 2);
    if (chunks <= 0) return int(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    auto cp = static_cast<const float*>(clr);
    const unsigned blocks = unsigned(chunks);
    if (decay)
        sgd_plain_kernel<T, true><<<blocks, NT, 0, s>>>(t, cp, wd);
    else
        sgd_plain_kernel<T, false><<<blocks, NT, 0, s>>>(t, cp, wd);
    return int(cudaGetLastError());
}

}  // namespace

// The table's constants, for the wrapper to check its own against.
extern "C" int bigdl_fused_sgd_capacity() { return CAP; }
extern "C" int bigdl_fused_sgd_chunk() { return CHUNK; }

// K5 over `count` (1..CAP) leaves.  ptrs: count x 3 int64 (the device
// addresses of p, g and v of each leaf, p and v contiguous and updated in
// place); meta: count x 5 int64 (n, first chunk, I and H*W of a
// channels-last g or 0 and 0, 1 if p, v and g are read as float4).  clr:
// one float32 in device memory; mu = momentum, omd = 1 - dampening,
// wd = weight decay (applied when decay != 0); nesterov != 0 takes the
// Nesterov step.  One launch on `stream`; does not synchronise; returns
// cudaGetLastError() after the launch.
extern "C" int bigdl_fused_sgd_mom(const int64_t* ptrs, const int64_t* meta,
                                   int count, const void* clr, float mu,
                                   float omd, float wd, int decay,
                                   int nesterov, void* stream) {
    return launch_mom<float>(ptrs, meta, count, clr, mu, omd, wd, decay,
                             nesterov, stream);
}

// K6 over `count` leaves: ptrs and meta as for K5 (v's address is not
// read); clr and wd as for K5.  One launch on `stream`; does not
// synchronise; returns cudaGetLastError().
extern "C" int bigdl_fused_sgd_plain(const int64_t* ptrs,
                                     const int64_t* meta, int count,
                                     const void* clr, float wd, int decay,
                                     void* stream) {
    return launch_plain<float>(ptrs, meta, count, clr, wd, decay, stream);
}

// K5 and K6 over bfloat16 leaves (p, g and v all bfloat16): the same
// arguments; each pointer is read as four bfloat16s where the leaf's
// float4 flag is set, which then means 8-byte aligned.
extern "C" int bigdl_fused_sgd_mom_bf16(const int64_t* ptrs,
                                        const int64_t* meta, int count,
                                        const void* clr, float mu,
                                        float omd, float wd, int decay,
                                        int nesterov, void* stream) {
    return launch_mom<__nv_bfloat16>(ptrs, meta, count, clr, mu, omd, wd,
                                     decay, nesterov, stream);
}

extern "C" int bigdl_fused_sgd_plain_bf16(const int64_t* ptrs,
                                          const int64_t* meta, int count,
                                          const void* clr, float wd,
                                          int decay, void* stream) {
    return launch_plain<__nv_bfloat16>(ptrs, meta, count, clr, wd, decay,
                                       stream);
}
