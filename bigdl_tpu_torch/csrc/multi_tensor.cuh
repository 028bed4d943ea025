// The multi-tensor launch table shared by the optimizer kernels
// (fused_sgd.cu, K5 and K6; fused_adam.cu, K4): one update of many leaves
// is one launch over a table of the leaves, built on the host by
// bigdl_tpu_torch/kernels/fused_optim.py:leaf_tables.
//
//   * The table is a __grid_constant__ kernel parameter (up to 32,764
//     bytes on sm_90 with CUDA >= 12.1), so the dynamic indexing below
//     reads the parameter bank and copies nothing to local memory.  It
//     holds CAP leaves, CAP set by each kernel from its pointer count; a
//     longer list of leaves is split by the wrapper into
//     ceil(leaves / CAP) launches.
//   * The grid is chunked: leaf l owns chunks start[l] .. start[l+1]-1 of
//     CHUNK elements each, and block b finds its leaf by a binary search of
//     start (the same for every thread, so it is a broadcast read).  Chunk
//     offsets are int64.
//   * Each thread moves VPT float4s where the leaf's pointers are 16-byte
//     aligned (decided per leaf on the host from the pointers' low bits);
//     a leaf that is not takes a scalar path.  The last chunk's ragged
//     tail is bounds-checked.
//   * A gradient in the channels-last order of its OIHW leaf (cuDNN's
//     weight gradient of an NHWC conv) is read in place: p's element
//     ((o*I + i)*HW + hw) takes g's element ((o*HW + hw)*I + i)
//     (cl_index).  The host gives this tag only to leaves below 2^31
//     elements, so the index map runs in 32 bits.
//   * A leaf is float32 or bfloat16: a kernel is instantiated for each
//     element type (Elem<T>: float4 loads and stores of four floats, or
//     8-byte loads and stores of four bfloat16s, which the host's vec
//     flag then requires 8-byte aligned; the arithmetic is in float, and
//     Elem<T>::rd rounds a result to T, the identity for float).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mt {

constexpr int NT = 256;                     // threads a block
constexpr int VPT = 4;                      // float4s a thread
constexpr int CHUNK = NT * VPT * 4;         // elements a block: 4096
// sm_90's kernel parameter space, which a table and its kernel's other
// arguments share
constexpr int PARAM_BYTES = 32764;

// The leaves of one launch.  Column 0 of ptr is p, column 1 g, the others
// the state updated in place (K5's velocity; K4's m and v); a kernel of
// element type T reads each address as a T*.
template <int NPTR, int CAP>
struct LeafTable {
    float* ptr[NPTR][CAP];
    int64_t n[CAP];
    int32_t start[CAP];         // first chunk of each leaf (prefix sum)
    int32_t cin[CAP];           // > 0: g channels-last, I of the OIHW leaf
    int32_t hw[CAP];            // H*W of such a leaf
    uint8_t vec[CAP];           // 1: every pointer read as float4 aligned
    int32_t count;
};

// What block blockIdx.x updates: elements off .. off + len - 1 of leaf.
struct Chunk {
    int leaf;
    int64_t off;
    int len;
};

template <int NPTR, int CAP>
__device__ __forceinline__ Chunk find_chunk(const LeafTable<NPTR, CAP>& t) {
    const int b = int(blockIdx.x);
    int lo = 0, hi = t.count - 1;           // the last leaf with start <= b
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (t.start[mid] <= b) lo = mid; else hi = mid - 1;
    }
    const int64_t off = int64_t(b - t.start[lo]) * CHUNK;
    const int64_t left = t.n[lo] - off;
    return {lo, off, left < CHUNK ? int(left) : CHUNK};
}

// Element access of a leaf of T, in floats; every load and store touches
// its bytes once (__ldcs / __stcs).
template <typename T>
struct Elem;

template <>
struct Elem<float> {
    static __device__ __forceinline__ float4 ld4(const float* p, int j) {
        return __ldcs(reinterpret_cast<const float4*>(p) + j);
    }
    static __device__ __forceinline__ void st4(float* p, int j, float4 v) {
        __stcs(reinterpret_cast<float4*>(p) + j, v);
    }
    static __device__ __forceinline__ float ld(const float* p, int64_t e) {
        return __ldcs(p + e);
    }
    static __device__ __forceinline__ void st(float* p, int64_t e,
                                              float v) {
        __stcs(p + e, v);
    }
    static __device__ __forceinline__ float rd(float x) { return x; }
};

template <>
struct Elem<__nv_bfloat16> {
    using B = __nv_bfloat16;
    static __device__ __forceinline__ float4 ld4(const B* p, int j) {
        const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p) + j);
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.y));
        return make_float4(a.x, a.y, b.x, b.y);
    }
    static __device__ __forceinline__ void st4(B* p, int j, float4 v) {
        __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
        __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
        uint2 u;
        u.x = *reinterpret_cast<unsigned*>(&a);
        u.y = *reinterpret_cast<unsigned*>(&b);
        __stcs(reinterpret_cast<uint2*>(p) + j, u);
    }
    static __device__ __forceinline__ float ld(const B* p, int64_t e) {
        return __bfloat162float(__ushort_as_bfloat16(
            __ldcs(reinterpret_cast<const unsigned short*>(p) + e)));
    }
    static __device__ __forceinline__ void st(B* p, int64_t e, float v) {
        __stcs(reinterpret_cast<unsigned short*>(p) + e,
               __bfloat16_as_ushort(__float2bfloat16_rn(v)));
    }
    // round to the nearest bfloat16, ties to even, as PyTorch rounds the
    // float result of each elementwise op on a bfloat16 tensor
    static __device__ __forceinline__ float rd(float x) {
        return __bfloat162float(__float2bfloat16_rn(x));
    }
};

__device__ __forceinline__ uint32_t cl_index(uint32_t e, uint32_t cin,
                                             uint32_t hw) {
    const uint32_t per_o = cin * hw;
    const uint32_t o = e / per_o, r = e - o * per_o;
    const uint32_t i = r / hw, s = r - i * hw;
    return (o * hw + s) * cin + i;
}

// Fills the table from the host arrays: ptrs count x NPTR int64 (p, g,
// then the state), meta count x 5 int64 (n, first chunk, I and H*W of a
// channels-last g or 0 and 0, float4 flag).  The first `required` columns
// of ptrs must be set.  Returns the number of chunks (blocks), or -1 if
// the arrays are not a table the kernel takes.
template <int NPTR, int CAP>
int64_t fill(LeafTable<NPTR, CAP>& t, const int64_t* ptrs,
             const int64_t* meta, int count, int required) {
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
        for (int j = 0; j < NPTR; ++j) {
            t.ptr[j][l] = reinterpret_cast<float*>(ptrs[NPTR * l + j]);
            if (j < required && t.ptr[j][l] == nullptr) return -1;
        }
        t.n[l] = n;
        t.start[l] = int32_t(chunks);
        t.cin[l] = int32_t(m[2]);
        t.hw[l] = int32_t(m[3]);
        t.vec[l] = uint8_t(m[4] != 0);
        chunks += (n + CHUNK - 1) / CHUNK;
    }
    return chunks < (int64_t(1) << 31) ? chunks : -1;
}

}  // namespace mt
