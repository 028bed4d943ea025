// Device helpers shared by the flash-attention kernels on the tensor cores
// (flash_fwd.cu, K1; flash_bwd.cu, K2 and K3): cp.async staging of row
// tiles, split TF32 and bf16 mma.sync, ldmatrix, quad reductions, and the
// host's choice of copy width.  Register layouts are the PTX ISA's for
// mma.m16n8k8 and mma.m16n8k16: lane (g = lane / 4, t = lane % 4) holds
// accumulator elements (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace fmma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait1() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait0() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// x = hi + lo, hi = x rounded to TF32 (nearest, ties away from zero) and
// lo = x - hi exactly.  hi is rounded as cvt.rna.tf32.f32 rounds a finite
// x, in 2 instructions (sm_90 lowers the cvt to 4: an inf test, this add,
// a select and this mask).  lo goes to the MMA as it is: a TF32 operand
// is read with its 13 low bits ignored, so lo enters truncated (CUTLASS's
// round_toward_zero tf32 conversion), losing at most 2^-21 of x.  A NaN
// in x stays NaN in lo.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
}

// The MMAs are not volatile: they only read and write registers, so the
// compiler may interleave independent ones.
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[i] += a * b[i] for N accumulators in split TF32: lo*hi + hi*lo first,
// then hi*hi.  Each pass runs over all N accumulators, so that an MMA
// never waits for the one just before it.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (*c)[4], const uint32_t* ahi,
                                           const uint32_t* alo,
                                           const float (*b)[2]) {
    uint32_t bh[N][2], bl[N][2];
#pragma unroll
    for (int i = 0; i < N; ++i) {
        split(b[i][0], bh[i][0], bl[i][0]);
        split(b[i][1], bh[i][1], bl[i][1]);
    }
#pragma unroll
    for (int i = 0; i < N; ++i) mma_tf32(c[i], alo, bh[i][0], bh[i][1]);
#pragma unroll
    for (int i = 0; i < N; ++i) mma_tf32(c[i], ahi, bl[i][0], bl[i][1]);
#pragma unroll
    for (int i = 0; i < N; ++i) mma_tf32(c[i], ahi, bh[i][0], bh[i][1]);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
        "{%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}

// (hi, lo) of two fp32 values as packed bf16 pairs: x = bf16(x) + bf16 of
// the rest, ~16 bits of x in all
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float quad_max(float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Start the copies of ROWS rows of D elements from row r0 of `src` (row
// stride ss) into a shared tile of row stride DP; rows at or past n are
// zero-filled (nothing is read for them).  Thread i of the NT copies
// chunks i, i + NT, ... of BYTES each.
template <typename T, int D, int DP, int ROWS, int NT, int BYTES>
__device__ __forceinline__ void copy_chunks(T* dst, const T* src,
                                            int64_t ss, int r0, int n) {
    constexpr int E = BYTES / sizeof(T), PER_ROW = D / E;
    constexpr int STEP = NT / PER_ROW;          // rows between a thread's
    static_assert(NT % PER_ROW == 0 && ROWS % STEP == 0, "copy layout");
    const int r = threadIdx.x / PER_ROW, c = threadIdx.x % PER_ROW * E;
    const T* from = src + (r0 + r) * ss + c;
    T* to = dst + r * DP + c;
#pragma unroll
    for (int m = 0; m < ROWS / STEP; ++m) {
        const bool in = r0 + r + m * STEP < n;
        const T* f = in ? from + m * STEP * ss : src;
        if constexpr (BYTES == 16)
            cp_async16(to + m * STEP * DP, f, in ? 16 : 0);
        else
            cp_async4(to + m * STEP * DP, f, in ? 4 : 0);
    }
}

template <typename T, int D, int DP, int ROWS, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t ss,
                                          int r0, int n, bool vec16) {
    if (vec16)
        copy_chunks<T, D, DP, ROWS, NT, 16>(dst, src, ss, r0, n);
    else
        copy_chunks<T, D, DP, ROWS, NT, 4>(dst, src, ss, r0, n);
}

// The bytes of each cp.async of the row tiles of n operands with these
// pointers and (batch, head, seq) element strides st[i][0..2] of `item`
// bytes an element: 16 when every pointer and stride is 16-byte aligned,
// else 4; 0 when not even 4-byte aligned.
inline int copy_bytes(const void* const* ptrs, const int64_t (*st)[3],
                      int n, int item) {
    for (int align : {16, 4}) {
        bool ok = true;
        for (int i = 0; i < n; ++i) {
            ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % align == 0;
            for (int j = 0; j < 3; ++j) ok = ok && (st[i][j] * item) % align
                                                       == 0;
        }
        if (ok) return align;
    }
    return 0;
}

}  // namespace fmma
