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

template <bool DECAY>
__device__ __forceinline__ void update(float& p, float& m, float& v,
                                       float g, const Scalars& s) {
    const float p0 = p;
    m = s.b1 * m + s.omb1 * g;
    v = s.b2 * v + (s.omb2 * g) * g;
    p = p0 - (s.clr * (m / s.bc1)) / (sqrtf(v / s.bc2) + s.eps);
    if (DECAY) p = p - s.cwd * p0;
}

template <bool DECAY>
__device__ __forceinline__ void update4(float4& p, float4& m, float4& v,
                                        const float4& g, const Scalars& s) {
    update<DECAY>(p.x, m.x, v.x, g.x, s);
    update<DECAY>(p.y, m.y, v.y, g.y, s);
    update<DECAY>(p.z, m.z, v.z, g.z, s);
    update<DECAY>(p.w, m.w, v.w, g.w, s);
}

template <bool DECAY>
__global__ void __launch_bounds__(NT)
fused_adam_kernel(const __grid_constant__ AdamTable t,
                  const float* __restrict__ clr_p,
                  const float* __restrict__ bc1_p,
                  const float* __restrict__ bc2_p, float b1, float omb1,
                  float b2, float omb2, float eps, float wd) {
    const mt::Chunk c = mt::find_chunk(t);
    const int l = c.leaf, len = c.len;
    const int64_t off = c.off;
    float* __restrict__ p = t.ptr[0][l] + off;
    const float* __restrict__ g = t.ptr[1][l];
    float* __restrict__ m = t.ptr[2][l] + off;
    float* __restrict__ v = t.ptr[3][l] + off;
    const uint32_t cin = uint32_t(t.cin[l]), hw = uint32_t(t.hw[l]);
    const float clr = *clr_p;
    const Scalars s{clr, *bc1_p, *bc2_p, b1, omb1, b2, omb2, eps,
                    DECAY ? clr * wd : 0.f};

    if (t.vec[l]) {
        const int nv = len >> 2;
        float4 pv[VPT], mv[VPT], vv[VPT], gv[VPT];
#pragma unroll
        for (int k = 0; k < VPT; ++k) {
            const int j = threadIdx.x + k * NT;
            if (j < nv) {
                pv[k] = __ldcs(reinterpret_cast<const float4*>(p) + j);
                mv[k] = __ldcs(reinterpret_cast<const float4*>(m) + j);
                vv[k] = __ldcs(reinterpret_cast<const float4*>(v) + j);
                if (cin == 0) {
                    gv[k] = __ldcs(reinterpret_cast<const float4*>(g + off)
                                   + j);
                } else {
                    const uint32_t e = uint32_t(off) + 4u * uint32_t(j);
                    gv[k].x = __ldcs(g + cl_index(e, cin, hw));
                    gv[k].y = __ldcs(g + cl_index(e + 1, cin, hw));
                    gv[k].z = __ldcs(g + cl_index(e + 2, cin, hw));
                    gv[k].w = __ldcs(g + cl_index(e + 3, cin, hw));
                }
            }
        }
#pragma unroll
        for (int k = 0; k < VPT; ++k) {
            const int j = threadIdx.x + k * NT;
            if (j < nv) {
                update4<DECAY>(pv[k], mv[k], vv[k], gv[k], s);
                __stcs(reinterpret_cast<float4*>(p) + j, pv[k]);
                __stcs(reinterpret_cast<float4*>(m) + j, mv[k]);
                __stcs(reinterpret_cast<float4*>(v) + j, vv[k]);
            }
        }
        // the ragged tail of a leaf's last chunk: at most 3 elements
        const int e = (nv << 2) + threadIdx.x;
        if (e < len) {
            float pe = p[e], me = m[e], ve = v[e];
            const float ge = cin == 0
                ? g[off + e] : g[cl_index(uint32_t(off + e), cin, hw)];
            update<DECAY>(pe, me, ve, ge, s);
            p[e] = pe;
            m[e] = me;
            v[e] = ve;
        }
    } else {
        for (int e = threadIdx.x; e < len; e += NT) {
            float pe = __ldcs(p + e), me = __ldcs(m + e), ve = __ldcs(v + e);
            const float ge = cin == 0
                ? __ldcs(g + off + e)
                : __ldcs(g + cl_index(uint32_t(off + e), cin, hw));
            update<DECAY>(pe, me, ve, ge, s);
            __stcs(p + e, pe);
            __stcs(m + e, me);
            __stcs(v + e, ve);
        }
    }
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
    AdamTable t;
    const int64_t chunks = mt::fill(t, ptrs, meta, count, 4);
    if (chunks <= 0) return int(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    auto cp = static_cast<const float*>(clr);
    auto b1p = static_cast<const float*>(bc1);
    auto b2p = static_cast<const float*>(bc2);
    const unsigned blocks = unsigned(chunks);
    if (decay)
        fused_adam_kernel<true><<<blocks, NT, 0, s>>>(
            t, cp, b1p, b2p, b1, omb1, b2, omb2, eps, wd);
    else
        fused_adam_kernel<false><<<blocks, NT, 0, s>>>(
            t, cp, b1p, b2p, b1, omb1, b2, omb2, eps, wd);
    return int(cudaGetLastError());
}
