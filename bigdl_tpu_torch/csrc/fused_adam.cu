// Fused Adam / AdamW update for Hopper (sm_90a), with a plain C interface
// (built by bigdl_tpu_torch/ops/_build.py with -fmad=false, bound with
// ctypes in bigdl_tpu_torch/kernels/fused_optim.py).
//
// Replaces: bigdl_tpu/kernels/fused_optim.py:124 _adam_kernel (K4, via
// fused_adam_update and _run_blocked, pallas_call at :110), the Pallas TPU
// kernel of the reference.  Same function, in the op order of _adam_kernel
// and optim_method.Adam.update:
//
//   m = b1 * m + (1 - b1) * g
//   v = b2 * v + (1 - b2) * g * g            ((1 - b2) * g) * g
//   p = p - clr * (m / bc1) / (sqrt(v / bc2) + eps)
//   p = p - clr * wd * p_old                 AdamW only, (clr * wd) * p_old
//
// The caller computes b1, 1 - b1, b2, 1 - b2, eps and wd on the host as
// the plain version does (Python doubles rounded to fp32), and hands the
// step-dependent clr, bc1 and bc2 as fp32 scalars in device memory, so an
// update costs no host sync.  The file is compiled with -fmad=false and
// nvcc's default IEEE division and square root: every operation rounds on
// its own, as PyTorch's elementwise kernels do one op at a time, so the
// result is bitwise equal to the plain PyTorch version on the card.  A
// division is never turned into a multiply by a reciprocal: that would
// round differently.
//
// What bounds it on an H100: bytes.  28 bytes an element (p, m, v, g read,
// p, m, v written) against ~13 FLOP, three of them IEEE divisions and one
// an IEEE square root; over the 162,417,408 parameters of TransformerLM
// base that is 4.55 GB, 1.36 ms at 3.35 TB/s.  Most of base's 111 leaves
// are LayerNorm vectors of 768 or 3072 values, so a launch per leaf pays a
// launch and a host call for a few kilobytes each.
//
// Design: one multi-tensor launch per update over a LeafTable of p, g, m
// and v (csrc/multi_tensor.cuh: the table, the chunked grid, the float4
// and scalar paths, the channels-last map), as K5 and K6 do.  Each thread
// makes all its loads of p, m, v and g (__ldcs: every byte is touched
// once) before any arithmetic and writes back with __stcs.  clr, bc1 and
// bc2 are loaded once a thread, from one address a block.  AdamW's decay
// is a template parameter.
//
// bfloat16 leaves (p, g, m and v all bfloat16) take their own
// instantiation (bigdl_fused_adam_bf16), the reference's per-leaf math for
// a leaf that is not float32 (bigdl_tpu/kernels/fused_optim.py:154-166):
// the moments in bfloat16, each operation's float result rounded to
// bfloat16 as PyTorch's eager ops round it, with b1, omb1, b2 and omb2
// rounded to bfloat16 by the wrapper, as JAX rounds the reference's weakly
// typed scalars (0.999 becomes 1.0); the step in float32, since clr, bc1
// and bc2 are float32 and promote it, then cast to bfloat16 and
// subtracted; AdamW's clr * wd rounded to bfloat16 before it scales
// p_old.  The wrapper sends each dtype's leaves to its own launch.
#include <cuda_runtime.h>
#include <stdint.h>

#include "multi_tensor.cuh"

namespace {

using mt::NT;
using mt::VPT;
using mt::cl_index;
constexpr int CAP = 616;                    // leaves a launch

using AdamTable = mt::LeafTable<4, CAP>;    // p, g, m, v
// the table plus clr, bc1, bc2, b1, 1 - b1, b2, 1 - b2, eps and wd within
// sm_90's kernel parameters
static_assert(sizeof(AdamTable) + 3 * sizeof(void*) + 6 * sizeof(float)
                  <= mt::PARAM_BYTES,
              "AdamTable exceeds the kernel parameter space");

struct Scalars {
    float clr, bc1, bc2, b1, omb1, b2, omb2, eps, cwd;
};

// One element in the op order of the plain version, each result rounded
// to T as PyTorch rounds each op on a T tensor (E::rd; the identity for
// float); the step is float throughout, as clr, bc1 and bc2 promote it.
template <typename T, bool DECAY>
__device__ __forceinline__ void update(float& p, float& m, float& v,
                                       float g, const Scalars& s) {
    using E = mt::Elem<T>;
    const float p0 = p;
    m = E::rd(E::rd(s.b1 * m) + E::rd(s.omb1 * g));
    v = E::rd(E::rd(s.b2 * v) + E::rd(E::rd(s.omb2 * g) * g));
    p = E::rd(p0 - E::rd((s.clr * (m / s.bc1))
                         / (sqrtf(v / s.bc2) + s.eps)));
    if (DECAY) p = E::rd(p - E::rd(s.cwd * p0));
}

template <typename T, bool DECAY>
__device__ __forceinline__ void update4(float4& p, float4& m, float4& v,
                                        const float4& g, const Scalars& s) {
    update<T, DECAY>(p.x, m.x, v.x, g.x, s);
    update<T, DECAY>(p.y, m.y, v.y, g.y, s);
    update<T, DECAY>(p.z, m.z, v.z, g.z, s);
    update<T, DECAY>(p.w, m.w, v.w, g.w, s);
}

template <typename T, bool DECAY>
__global__ void __launch_bounds__(NT)
fused_adam_kernel(const __grid_constant__ AdamTable t,
                  const float* __restrict__ clr_p,
                  const float* __restrict__ bc1_p,
                  const float* __restrict__ bc2_p, float b1, float omb1,
                  float b2, float omb2, float eps, float wd) {
    using E = mt::Elem<T>;
    const mt::Chunk c = mt::find_chunk(t);
    const int l = c.leaf, len = c.len;
    const int64_t off = c.off;
    T* __restrict__ p = reinterpret_cast<T*>(t.ptr[0][l]) + off;
    const T* __restrict__ g = reinterpret_cast<const T*>(t.ptr[1][l]);
    T* __restrict__ m = reinterpret_cast<T*>(t.ptr[2][l]) + off;
    T* __restrict__ v = reinterpret_cast<T*>(t.ptr[3][l]) + off;
    const uint32_t cin = uint32_t(t.cin[l]), hw = uint32_t(t.hw[l]);
    const float clr = *clr_p;
    // AdamW's decay factor: clr * wd, rounded to T as the plain version
    // casts it
    const Scalars s{clr, *bc1_p, *bc2_p, b1, omb1, b2, omb2, eps,
                    DECAY ? E::rd(clr * wd) : 0.f};

    if (t.vec[l]) {
        const int nv = len >> 2;
        float4 pv[VPT], mv[VPT], vv[VPT], gv[VPT];
#pragma unroll
        for (int k = 0; k < VPT; ++k) {
            const int j = threadIdx.x + k * NT;
            if (j < nv) {
                pv[k] = E::ld4(p, j);
                mv[k] = E::ld4(m, j);
                vv[k] = E::ld4(v, j);
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
                update4<T, DECAY>(pv[k], mv[k], vv[k], gv[k], s);
                E::st4(p, j, pv[k]);
                E::st4(m, j, mv[k]);
                E::st4(v, j, vv[k]);
            }
        }
        // the ragged tail of a leaf's last chunk: at most 3 elements
        const int e = (nv << 2) + threadIdx.x;
        if (e < len) {
            float pe = E::ld(p, e), me = E::ld(m, e), ve = E::ld(v, e);
            const float ge = cin == 0
                ? E::ld(g, off + e)
                : E::ld(g, cl_index(uint32_t(off + e), cin, hw));
            update<T, DECAY>(pe, me, ve, ge, s);
            E::st(p, e, pe);
            E::st(m, e, me);
            E::st(v, e, ve);
        }
    } else {
        for (int e = threadIdx.x; e < len; e += NT) {
            float pe = E::ld(p, e), me = E::ld(m, e), ve = E::ld(v, e);
            const float ge = cin == 0
                ? E::ld(g, off + e)
                : E::ld(g, cl_index(uint32_t(off + e), cin, hw));
            update<T, DECAY>(pe, me, ve, ge, s);
            E::st(p, e, pe);
            E::st(m, e, me);
            E::st(v, e, ve);
        }
    }
}

template <typename T>
int launch(const int64_t* ptrs, const int64_t* meta, int count,
           const void* clr, const void* bc1, const void* bc2, float b1,
           float omb1, float b2, float omb2, float eps, float wd, int decay,
           void* stream) {
    AdamTable t;
    const int64_t chunks = mt::fill(t, ptrs, meta, count, 4);
    if (chunks <= 0) return int(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    auto cp = static_cast<const float*>(clr);
    auto b1p = static_cast<const float*>(bc1);
    auto b2p = static_cast<const float*>(bc2);
    const unsigned blocks = unsigned(chunks);
    if (decay)
        fused_adam_kernel<T, true><<<blocks, NT, 0, s>>>(
            t, cp, b1p, b2p, b1, omb1, b2, omb2, eps, wd);
    else
        fused_adam_kernel<T, false><<<blocks, NT, 0, s>>>(
            t, cp, b1p, b2p, b1, omb1, b2, omb2, eps, wd);
    return int(cudaGetLastError());
}

}  // namespace

// The table's constants, for the wrapper to check its own against.
extern "C" int bigdl_fused_adam_capacity() { return CAP; }
extern "C" int bigdl_fused_adam_chunk() { return mt::CHUNK; }

// K4 over `count` (1..CAP) leaves.  ptrs: count x 4 int64 (the device
// addresses of p, g, m and v of each leaf; p, m and v contiguous and
// updated in place); meta: count x 5 int64 (n, first chunk, I and H*W of
// a channels-last g or 0 and 0, 1 if p, m, v and g are read as float4).
// clr, bc1, bc2: one float32 each in device memory; b1, omb1 = 1 - b1, b2,
// omb2 = 1 - b2 and eps as the plain version rounds them; decay != 0
// applies AdamW's decoupled weight decay wd.  One launch on `stream`; does
// not synchronise; returns cudaGetLastError() after the launch.
extern "C" int bigdl_fused_adam(const int64_t* ptrs, const int64_t* meta,
                                int count, const void* clr, const void* bc1,
                                const void* bc2, float b1, float omb1,
                                float b2, float omb2, float eps, float wd,
                                int decay, void* stream) {
    return launch<float>(ptrs, meta, count, clr, bc1, bc2, b1, omb1, b2,
                         omb2, eps, wd, decay, stream);
}

// K4 over `count` bfloat16 leaves (p, g, m and v all bfloat16): the same
// arguments; each pointer is read as four bfloat16s where the leaf's
// float4 flag is set, which then means 8-byte aligned.
extern "C" int bigdl_fused_adam_bf16(const int64_t* ptrs,
                                     const int64_t* meta, int count,
                                     const void* clr, const void* bc1,
                                     const void* bc2, float b1, float omb1,
                                     float b2, float omb2, float eps,
                                     float wd, int decay, void* stream) {
    return launch<__nv_bfloat16>(ptrs, meta, count, clr, bc1, bc2, b1, omb1,
                                 b2, omb2, eps, wd, decay, stream);
}
