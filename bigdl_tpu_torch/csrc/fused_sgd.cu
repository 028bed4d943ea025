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
// Design: one multi-tensor launch per update.
//   * The leaves go to the kernel as one table, a __grid_constant__ kernel
//     parameter (up to 32,764 bytes on sm_90 with CUDA >= 12.1), so the
//     dynamic indexing below reads the parameter bank and copies nothing
//     to local memory.  It holds CAP leaves; a longer list of leaves is
//     split by the wrapper into ceil(leaves / CAP) launches.
//   * The grid is chunked: leaf l owns chunks start[l] .. start[l+1]-1 of
//     CHUNK elements each, and block b finds its leaf by a binary search of
//     start (the same for every thread, so it is a broadcast read).  A
//     batch-norm vector is one block; fc's 2048x1000 weight is 500 blocks;
//     ResNet-50 as a whole is about 6,300 blocks, some six waves of the
//     card's resident blocks.  Chunk offsets are int64.
//   * Each thread moves VPT float4s with 16-byte streaming loads and
//     stores (__ldcs/__stcs: every byte is touched once), all loads made
//     before any arithmetic, where the leaf's pointers are 16-byte aligned
//     (decided per leaf on the host from the pointers' low bits); a leaf
//     that is not takes the scalar path.  The last chunk's ragged tail is
//     bounds-checked.
//   * A gradient in the channels-last order of its OIHW leaf (cuDNN's
//     weight gradient of an NHWC conv) is read in place: p's element
//     ((o*I + i)*HW + hw) takes g's element ((o*HW + hw)*I + i).  p and v
//     stay vectorised, g is gathered with scalar loads.  The host gives
//     this tag only to leaves below 2^31 elements, so the index map runs
//     in 32 bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;                     // threads a block
constexpr int VPT = 4;                      // float4s a thread
constexpr int CHUNK = NT * VPT * 4;         // elements a block: 4096
constexpr int CAP = 720;                    // leaves a launch

struct LeafTable {
    float* p[CAP];
    float* v[CAP];              // K5's velocity; unused by K6
    const float* g[CAP];
    int64_t n[CAP];
    int32_t start[CAP];         // first chunk of each leaf (prefix sum)
    int32_t cin[CAP];           // > 0: g channels-last, I of the OIHW leaf
    int32_t hw[CAP];            // H*W of such a leaf
    uint8_t vec[CAP];           // 1: every pointer read as float4 aligned
    int32_t count;
};
// the table plus clr, mu, 1 - dampening and wd within sm_90's 32,764 bytes
// of kernel parameters
static_assert(sizeof(LeafTable) + sizeof(void*) + 3 * sizeof(float)
                  <= 32764, "LeafTable exceeds the kernel parameter space");

template <bool MOM, bool DECAY, bool NESTEROV>
__device__ __forceinline__ void update(float& p, float& v, float g,
                                       float clr, float mu, float omd,
                                       float wd) {
    if (DECAY) g = g + wd * p;
    if (MOM) {
        const float vel = mu * v + omd * g;
        const float step = NESTEROV ? g + mu * vel : vel;
        p = p - clr * step;
        v = vel;
    } else {
        p = p - clr * g;
    }
}

__device__ __forceinline__ uint32_t cl_index(uint32_t e, uint32_t cin,
                                             uint32_t hw) {
    const uint32_t per_o = cin * hw;
    const uint32_t o = e / per_o, r = e - o * per_o;
    const uint32_t i = r / hw, s = r - i * hw;
    return (o * hw + s) * cin + i;
}

template <bool MOM, bool DECAY, bool NESTEROV>
__device__ __forceinline__ void chunk_update(const LeafTable& t,
                                             const float* __restrict__ clr_p,
                                             float mu, float omd, float wd) {
    const int b = int(blockIdx.x);
    int lo = 0, hi = t.count - 1;           // the last leaf with start <= b
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (t.start[mid] <= b) lo = mid; else hi = mid - 1;
    }
    const int64_t off = int64_t(b - t.start[lo]) * CHUNK;
    const int64_t left = t.n[lo] - off;
    const int len = left < CHUNK ? int(left) : CHUNK;
    float* __restrict__ p = t.p[lo] + off;
    float* __restrict__ v = MOM ? t.v[lo] + off : nullptr;
    const float* __restrict__ g = t.g[lo];
    const uint32_t cin = uint32_t(t.cin[lo]), hw = uint32_t(t.hw[lo]);
    const float clr = *clr_p;

    if (t.vec[lo]) {
        const int nv = len >> 2;
        float4 pv[VPT], vv[VPT], gv[VPT];
#pragma unroll
        for (int k = 0; k < VPT; ++k) {
            const int j = threadIdx.x + k * NT;
            if (j < nv) {
                pv[k] = __ldcs(reinterpret_cast<const float4*>(p) + j);
                vv[k] = MOM ? __ldcs(reinterpret_cast<const float4*>(v) + j)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
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
                update<MOM, DECAY, NESTEROV>(pv[k].x, vv[k].x, gv[k].x, clr,
                                             mu, omd, wd);
                update<MOM, DECAY, NESTEROV>(pv[k].y, vv[k].y, gv[k].y, clr,
                                             mu, omd, wd);
                update<MOM, DECAY, NESTEROV>(pv[k].z, vv[k].z, gv[k].z, clr,
                                             mu, omd, wd);
                update<MOM, DECAY, NESTEROV>(pv[k].w, vv[k].w, gv[k].w, clr,
                                             mu, omd, wd);
                __stcs(reinterpret_cast<float4*>(p) + j, pv[k]);
                if (MOM) __stcs(reinterpret_cast<float4*>(v) + j, vv[k]);
            }
        }
        // the ragged tail of a leaf's last chunk: at most 3 elements
        const int e = (nv << 2) + threadIdx.x;
        if (e < len) {
            float pe = p[e], ve = MOM ? v[e] : 0.f;
            const float ge = cin == 0
                ? g[off + e] : g[cl_index(uint32_t(off + e), cin, hw)];
            update<MOM, DECAY, NESTEROV>(pe, ve, ge, clr, mu, omd, wd);
            p[e] = pe;
            if (MOM) v[e] = ve;
        }
    } else {
        for (int e = threadIdx.x; e < len; e += NT) {
            float pe = __ldcs(p + e), ve = MOM ? __ldcs(v + e) : 0.f;
            const float ge = cin == 0
                ? __ldcs(g + off + e)
                : __ldcs(g + cl_index(uint32_t(off + e), cin, hw));
            update<MOM, DECAY, NESTEROV>(pe, ve, ge, clr, mu, omd, wd);
            __stcs(p + e, pe);
            if (MOM) __stcs(v + e, ve);
        }
    }
}

template <bool DECAY, bool NESTEROV>
__global__ void __launch_bounds__(NT)
sgd_mom_kernel(const __grid_constant__ LeafTable t,
               const float* __restrict__ clr, float mu, float omd,
               float wd) {
    chunk_update<true, DECAY, NESTEROV>(t, clr, mu, omd, wd);
}

template <bool DECAY>
__global__ void __launch_bounds__(NT)
sgd_plain_kernel(const __grid_constant__ LeafTable t,
                 const float* __restrict__ clr, float wd) {
    chunk_update<false, DECAY, false>(t, clr, 0.f, 0.f, wd);
}

// Fills the table from the host arrays; returns the number of chunks
// (blocks), or -1 if the arrays are not a table this kernel takes.
int64_t fill(LeafTable& t, const int64_t* ptrs, const int64_t* meta,
             int count, bool mom) {
    if (count <= 0 || count > CAP) return -1;
    t.count = count;
    int64_t chunks = 0;
    for (int l = 0; l < count; ++l) {
        const int64_t* m = meta + 5 * l;
        const int64_t n = m[0];
        if (n <= 0 || m[1] != chunks || m[2] < 0 || m[3] < 0
            || (m[2] > 0 && (m[2] * m[3] == 0 || n % (m[2] * m[3]) != 0
                             || n >= (int64_t(1) << 31))))
            return -1;
        t.p[l] = reinterpret_cast<float*>(ptrs[3 * l]);
        t.g[l] = reinterpret_cast<const float*>(ptrs[3 * l + 1]);
        t.v[l] = reinterpret_cast<float*>(ptrs[3 * l + 2]);
        if (mom && t.v[l] == nullptr) return -1;
        t.n[l] = n;
        t.start[l] = int32_t(chunks);
        t.cin[l] = int32_t(m[2]);
        t.hw[l] = int32_t(m[3]);
        t.vec[l] = uint8_t(m[4] != 0);
        chunks += (n + CHUNK - 1) / CHUNK;
    }
    return chunks < (int64_t(1) << 31) ? chunks : -1;
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
    LeafTable t;
    const int64_t chunks = fill(t, ptrs, meta, count, true);
    if (chunks <= 0) return int(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    auto cp = static_cast<const float*>(clr);
    const unsigned blocks = unsigned(chunks);
    if (decay && nesterov)
        sgd_mom_kernel<true, true><<<blocks, NT, 0, s>>>(t, cp, mu, omd, wd);
    else if (decay)
        sgd_mom_kernel<true, false><<<blocks, NT, 0, s>>>(t, cp, mu, omd, wd);
    else if (nesterov)
        sgd_mom_kernel<false, true><<<blocks, NT, 0, s>>>(t, cp, mu, omd, wd);
    else
        sgd_mom_kernel<false, false><<<blocks, NT, 0, s>>>(t, cp, mu, omd,
                                                           wd);
    return int(cudaGetLastError());
}

// K6 over `count` leaves: ptrs and meta as for K5 (v's address is not
// read); clr and wd as for K5.  One launch on `stream`; does not
// synchronise; returns cudaGetLastError().
extern "C" int bigdl_fused_sgd_plain(const int64_t* ptrs,
                                     const int64_t* meta, int count,
                                     const void* clr, float wd, int decay,
                                     void* stream) {
    LeafTable t;
    const int64_t chunks = fill(t, ptrs, meta, count, false);
    if (chunks <= 0) return int(cudaErrorInvalidValue);
    auto s = static_cast<cudaStream_t>(stream);
    auto cp = static_cast<const float*>(clr);
    const unsigned blocks = unsigned(chunks);
    if (decay)
        sgd_plain_kernel<true><<<blocks, NT, 0, s>>>(t, cp, wd);
    else
        sgd_plain_kernel<false><<<blocks, NT, 0, s>>>(t, cp, wd);
    return int(cudaGetLastError());
}
